"""Model bundle (port of ``repro.models.registry``): one object per
architecture exposing the spec, initialisation, the three forward modes
(train logits, prefill, decode) and the decode cache. Family dispatch
happens here, as in the reference: encoder-decoder models (``is_encdec``)
go to ``encdec``, VLMs (``modality == "image_patches"``) pass their
``image_embeds`` before the tokens, every other family is a plain
``lm.forward``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models import params as pspec
from repro_torch.utils import resolve_device


class Bundle:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def spec(self):
        if self.cfg.is_encdec:
            return encdec.encdec_spec(self.cfg)
        return lm.model_spec(self.cfg)

    def init(self, gen: torch.Generator):
        return pspec.materialize(self.spec(), gen)

    def abstract_params(self):
        return pspec.abstract(self.spec())

    def _image(self):
        return self.cfg.modality == "image_patches"

    def train_logits(self, params, batch):
        cfg = self.cfg
        if cfg.is_encdec:
            return encdec.train_logits(params, cfg, batch["frames"],
                                       batch["tokens"])
        logits, _ = lm.forward(
            params, cfg, mode="train", tokens=batch["tokens"],
            image_embeds=batch["image_embeds"] if self._image() else None)
        return logits[:, cfg.img_tokens:] if self._image() else logits

    def prefill(self, params, batch, cache_len=None):
        """The cache holds ``cache_len`` slots (default: the prefilled
        length, image rows included); decode continues at that length."""
        cfg = self.cfg
        if cfg.is_encdec:
            return encdec.prefill(params, cfg, batch["frames"],
                                  batch["tokens"], cache_len=cache_len)
        return lm.forward(
            params, cfg, mode="prefill", tokens=batch["tokens"],
            image_embeds=batch["image_embeds"] if self._image() else None,
            cache_len=cache_len)

    def decode(self, params, cache, tokens, cur_index):
        if self.cfg.is_encdec:
            return encdec.decode(params, self.cfg, cache, tokens, cur_index)
        return lm.forward(params, self.cfg, mode="decode", tokens=tokens,
                          cache=cache, cur_index=cur_index)

    def init_cache(self, batch: int, max_len: int, cross_len: int = 0,
                   dtype=torch.bfloat16, device="cuda"):
        return lm.init_cache(self.cfg, batch, max_len, dtype,
                             resolve_device(device), cross_len)

    def cache_abstract(self, batch: int, max_len: int, cross_len: int = 0,
                       dtype=torch.bfloat16):
        return lm.cache_abstract(self.cfg, batch, max_len, dtype, cross_len)

    def cache_axes(self, cross_len: int = 0):
        return lm.cache_logical_axes(self.cfg, cross_len)


def get_bundle(cfg: ModelConfig) -> Bundle:
    return Bundle(cfg)
