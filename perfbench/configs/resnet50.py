"""Adapter of the ``resnet50`` configuration: ``cell["instances"]``
ResNet-50 models, each a ``TorchModel(model_id, resnet50_forward,
port_layout(weights), ...)`` (what ``make_resnet_model`` builds, with the
configuration's 1,000 classes), on its own weights drawn from the seed.
See ``perfbench/harness/deploy.py`` for what a deployment exposes."""
from __future__ import annotations

import math

import torch

from perfbench.harness import deploy as dp
from perfbench.harness import roofline
from perfbench.harness import weights as wt
from perfbench.reference import resnet50 as reference
from repro_torch.models import params as pspec
from repro_torch.models.resnet import (STAGES, port_layout, resnet50_forward,
                                       resnet50_spec)
from repro_torch.serving.engine import TorchModel

WEIGHTS_STREAM, INPUT_STREAM = 11, 12


def _recipe(path, spec):
    """(std, mean) of each leaf: convs and the head at 1/sqrt(fan_in),
    folded BN scale around 1 and bias around 0."""
    if path[-1] == "scale":
        return 0.1, 1.0
    if path[-1] == "bias":
        return 0.1, 0.0
    fan_in = math.prod(spec.shape[:-1])        # HWIO: kh * kw * C_in
    return fan_in ** -0.5, 0.0


class Deployment:
    def __init__(self, sizes, cell, seed, device, tiny):
        sizes = {**sizes, **(tiny or {})}
        self.sizes, self.seed, self.device = sizes, seed, device
        scale = 512 // sizes["widths"][-1]     # resnet50_spec shrinks by this
        self.spec = resnet50_spec(num_classes=sizes["num_classes"],
                                  scale=scale)
        widths = [self.spec[f"stage{i}"][0]["conv1"].shape[-1]
                  for i in range(len(STAGES))]
        if (list(STAGES) != sizes["stages"] or widths != sizes["widths"]
                or self.spec["stem"].shape[0] != sizes["stem_kernel"]):
            raise ValueError(f"the served ResNet ({STAGES}, {widths}) is not "
                             f"the configuration's {sizes}")
        self.buckets = tuple(sizes["buckets"])
        self.weights_bytes = pspec.param_bytes(self.spec)
        self.last_input = None
        n = sizes["input_pool"]
        img = sizes["image_size"]
        pool = torch.randn((n, img, img, sizes["channels"]),
                           generator=wt.generator(seed, device, INPUT_STREAM),
                           device=device)
        self.pool = dp.host_copy(pool, device)
        self.slices = dp.Slices(n, seed)
        self.engines = {}
        for i in range(cell["instances"]):
            raw = self.weights(i)
            self.engines[f"resnet50-{i}"] = TorchModel(
                f"resnet50-{i}", resnet50_forward, port_layout(raw),
                self.make_input, weights_bytes=self.weights_bytes,
                batches=self.buckets, device=device)
            del raw
        first, *others = self.engines.values()
        dp.seed_replicas(first, others)

    def weights(self, index: int):
        """Model ``index``'s weights as drawn: HWIO convs, (C,) BN vectors,
        the (C, classes) head, in bfloat16 on the device."""
        return dp.draw_tree(self.spec, _recipe, self.seed, self.device,
                            WEIGHTS_STREAM, index)

    def make_input(self, b: int):
        """Batch ``b``'s images: a slice of the pinned pool copied to the
        card, as NCHW in channels_last (the forward's layout)."""
        start = self.slices.start(b)
        self.last_input = (start, b)
        x = self.pool[start:start + b].to(self.device, non_blocking=True)
        return x.permute(0, 3, 1, 2)

    def flops_per_row(self) -> float:
        return roofline.resnet50_flops(self.sizes)

    def kernel_work(self, bucket: int) -> dict:
        return {}

    def port_kernels_per_infer(self) -> dict:
        return {}

    def release(self):
        self.engines = {}

    def compare(self, samples, precision: str):
        """(samples, program logits, reference logits) in blocks of rows,
        float32, the reference on the weights and images drawn again."""
        for index, block in dp.blocks(samples):
            raw = self.weights(index)
            rows = torch.tensor([s.row for s in block])
            x = self.pool[rows].to(self.device)
            prog = torch.stack([s.output for s in block]).float()
            yield block, prog, reference.forward(raw, x, precision)
            del raw


def build(sizes, cell, seed, device, tiny=None, reuse=None):
    return Deployment(sizes, cell, seed, device, tiny)
