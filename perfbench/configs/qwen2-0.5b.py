"""Adapter of the ``qwen2-0.5b`` configuration: one model made by
``make_lm_decode_model(full=True, ctx, batches)``, whose INFER is one
decode step at ``cur`` against the zeroed cache it makes inside the call.
The benchmark replaces the factory's host weights with its own, drawn from
the seed, before the first LOAD, and its ``make_input`` with token ids
from a seeded pool. See ``perfbench/harness/deploy.py`` for what a
deployment exposes."""
from __future__ import annotations

import math

import torch

from perfbench.harness import deploy as dp
from perfbench.harness import roofline
from perfbench.harness import weights as wt
from perfbench.reference import qwen2 as reference
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.registry import get_bundle
from repro_torch.serving.engine import make_lm_decode_model

ARCH = "qwen2-0.5b"
WEIGHTS_STREAM, INPUT_STREAM = 21, 22

SIZES_OF = {"hidden_size": "d_model", "intermediate_size": "d_ff",
            "num_attention_heads": "n_heads",
            "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
            "num_hidden_layers": "num_layers", "vocab_size": "vocab_size",
            "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
            "tie_word_embeddings": "tie_embeddings"}


def key_bias_std(head_dim: int, cur: int) -> float:
    """b_q = b_k of its KV head, drawn with this deviation, gives the new
    token's own slot a score near |b|² / sqrt(D) = sqrt(D)·std² = ln(cur):
    it then holds about half the softmax weight against the ``cur`` zeroed
    slots before it, so which slots the kernel reads shows in the logits."""
    return math.sqrt(math.log(cur) / math.sqrt(head_dim))


def _recipe(d, bias_std):
    def recipe(path, spec):
        name = path[-1]
        if name == "embedding":
            return d ** -0.5, 0.0
        if name == "scale":                      # norm: weight 1 + scale
            return 0.1, 0.0
        if name == "b_v":
            return 0.5, 0.0
        if name in ("b_q", "b_k"):
            return bias_std, 0.0
        # (L, fan_in..., fan_out...): w_o's fan-in is H·D, the rest d or F
        fan_in = spec.shape[1] * spec.shape[2] if name == "w_o" \
            else spec.shape[1]
        return fan_in ** -0.5, 0.0
    return recipe


class Deployment:
    def __init__(self, sizes, cell, seed, device, tiny, reuse):
        self.seed, self.device = seed, device
        cfg = get_smoke_config(ARCH) if tiny else get_config(ARCH)
        serve = {**sizes["serve"], **((tiny or {}).get("serve", {}))}
        if tiny:     # the smoke model's own sizes stand in for the published
            sizes = {**sizes, **{k: getattr(cfg, v)
                                 for k, v in SIZES_OF.items()}}
        bad = {k: (sizes[k], getattr(cfg, v)) for k, v in SIZES_OF.items()
               if sizes[k] != getattr(cfg, v)}
        if bad or cfg.qkv_bias is not True or cfg.mlp != "swiglu":
            raise ValueError(f"the served {ARCH} differs from the "
                             f"configuration: {bad}")
        self.sizes, self.cfg = sizes, cfg
        self.ctx, self.cur = serve["ctx"], serve["cur"]
        if self.cur != self.ctx // 2:
            raise ValueError("make_lm_decode_model decodes at ctx // 2")
        self.buckets = tuple(serve["buckets"])
        self.spec = get_bundle(cfg).spec()
        key = (ARCH, bool(tiny), self.ctx, self.buckets, str(device))
        tm = (reuse or {}).get(key)
        fresh = tm is None
        if fresh:
            tm = make_lm_decode_model("qwen2-0.5b", arch=ARCH,
                                      batches=self.buckets, ctx=self.ctx,
                                      seed=0, full=not tiny, device=device)
            if reuse is not None:
                reuse[key] = tm
        tm.unload()
        tm.host_params = dp.host_copy(self.weights(), device)
        self.pool = torch.randint(
            0, sizes["vocab_size"], (serve["token_pool"],),
            generator=wt.generator(seed, device, INPUT_STREAM), device=device)
        self.slices = dp.Slices(serve["token_pool"], seed)
        self.last_input = None
        tm.make_input = self.make_input
        self.engines = {"qwen2-0.5b": tm}
        if fresh:      # a reused engine keeps the profiles of its shapes
            dp.seed_replicas(tm, [])

    def weights(self):
        """The weights as drawn, in the bundle spec's layout, bfloat16 on
        the device; each b_q is its KV head's b_k."""
        std = key_bias_std(self.sizes["head_dim"], self.cur)
        w = dp.draw_tree(self.spec, _recipe(self.sizes["hidden_size"], std),
                         self.seed, self.device, WEIGHTS_STREAM)
        g = self.sizes["num_attention_heads"] \
            // self.sizes["num_key_value_heads"]
        for block in w["stack"]:
            a = block["attn"]
            a["b_q"] = a["b_k"].repeat_interleave(g, dim=1).contiguous()
        return w

    def make_input(self, b: int):
        start = self.slices.start(b)
        self.last_input = (start, b)
        return self.pool[start:start + b].view(b, 1), self.cur

    def flops_per_row(self) -> float:
        return roofline.qwen2_decode_flops(self.sizes, self.cur)

    def _layers(self):
        return self.sizes["num_hidden_layers"]

    def kernel_work(self, bucket: int) -> dict:
        s = self.sizes
        nbytes, flops = roofline.flash_decode_work(
            bucket, s["num_attention_heads"], s["num_key_value_heads"],
            s["head_dim"], self.ctx, roofline.decode_attention_live(self.cur))
        return {"flash_decode": (nbytes * self._layers(),
                                 flops * self._layers())}

    def port_kernels_per_infer(self) -> dict:
        return {"flash_decode": self._layers()}

    def release(self):
        self.engines = {}

    def compare(self, samples, precision: str):
        """(samples, program logits, reference logits) in blocks of rows,
        float32, the reference on the weights and tokens drawn again."""
        raw = self.weights()
        v = self.sizes["vocab_size"]
        for _, block in dp.blocks(samples):
            tokens = self.pool[torch.tensor([s.row for s in block],
                                            device=self.pool.device)]
            prog = torch.stack([s.output[0] for s in block]).float()
            yield block, prog, reference.decode_logits(
                raw, self.sizes, tokens, self.cur, precision)[:, :v]


def build(sizes, cell, seed, device, tiny=None, reuse=None):
    return Deployment(sizes, cell, seed, device, tiny, reuse)
