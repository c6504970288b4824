"""Model bundle (port of ``repro.models.registry``): one object per
architecture exposing the spec, initialisation, the three forward modes
(train logits, prefill, decode) and the decode cache, for plain token
input. The dense and Mamba2 families are ported; the others raise
NotImplementedError when their spec or cache is built."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models import params as pspec
from repro_torch.utils import resolve_device


class Bundle:
    def __init__(self, cfg: ModelConfig):
        if cfg.is_encdec or cfg.modality is not None:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and VLM input are not ported "
                "yet (ROADMAP, modules to port)")
        self.cfg = cfg

    def spec(self):
        return lm.model_spec(self.cfg)

    def init(self, gen: torch.Generator):
        return pspec.materialize(self.spec(), gen)

    def train_logits(self, params, batch):
        logits, _ = lm.forward(params, self.cfg, mode="train",
                               tokens=batch["tokens"])
        return logits

    def prefill(self, params, batch, cache_len=None):
        return lm.forward(params, self.cfg, mode="prefill",
                          tokens=batch["tokens"], cache_len=cache_len)

    def decode(self, params, cache, tokens, cur_index):
        return lm.forward(params, self.cfg, mode="decode", tokens=tokens,
                          cache=cache, cur_index=cur_index)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        return lm.init_cache(self.cfg, batch, max_len, dtype,
                             resolve_device(device))


def get_bundle(cfg: ModelConfig) -> Bundle:
    return Bundle(cfg)
