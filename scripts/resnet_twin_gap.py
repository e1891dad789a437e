"""Where resnet50's bf16 step departs from its fp32 twin on the card, and
how far a planted precision fault moves that gap.

chip_smoke.py's families phase holds each family's bf16 step against an
fp32 twin of the same weights: the step-0 loss, and every parameter's
gradient (largest difference over the gradient's largest value). This
script reads the same two gaps for resnet50 (B=8, 224², each seed's
weights and batch as `TrainSession(seed=s)` makes them) with the fp32
twin computed once per seed, TF32 off (cuDNN and cuBLAS), and the bf16
pass run under variants:

  sound, as the port runs it or as the reference computes it:
    cudnn          the module as it runs: cuDNN's bf16 convolutions, the
                   library's TF32 flags as they are by default
    cudnn_no_tf32  the same with TF32 off in this pass too
    fp32_conv      every convolution in fp32 on its bf16-rounded input and
                   weight, the output rounded to bf16: a bf16 convolution
                   with an exact fp32 sum, as XLA computes one on the CPU
    m7_all         the planting below at 7 mantissa bits, which bf16 has
                   already: a check of the planting, which must read as
                   `cudnn` does
  faulty, planted:
    m{5,4,3}_init  conv_init's input, weight and output, and their
                   gradients, rounded to 5, 4 or 3 mantissa bits (bf16
                   keeps 7): one convolution in a lower precision
    m{5,4}_all     every convolution so
    fp16_all       every convolution in fp16 (10 mantissa bits, but a
                   range that ends at 65504)
  neither:
    bn_bf16        every BatchNorm in bf16 (the reference's are fp32); on
                   the initial statistics BatchNorm is x·rsqrt(1 + 1e-5),
                   which is x again once rounded to bf16

    python3 scripts/resnet_twin_gap.py [--seeds 0,1,2,3,4,5,6,7]

Prints the card's name and power limit, one line per seed and variant,
and a last line of JSON: each variant's readings of the worst gradient
gap over the seeds and their mean, the sound variants' largest and the
faulty ones' smallest. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOUND = ("cudnn", "cudnn_no_tf32", "fp32_conv", "m7_all")
FAULTY = ("m5_init", "m4_init", "m3_init", "m5_all", "m4_all", "fp16_all")
OTHER = ("bn_bf16",)


class Round(torch.autograd.Function):
    """fp32 `x` rounded to nearest even at `bits` mantissa bits, and its
    gradient rounded the same way: a value of a lower precision than fp32
    with fp32's exponent range."""

    @staticmethod
    def _round(x: torch.Tensor, bits: int) -> torch.Tensor:
        shift = 23 - bits
        xi = x.float().contiguous().view(torch.int32)
        bias = ((xi >> shift) & 1) + (1 << (shift - 1)) - 1
        return ((xi + bias) & ~((1 << shift) - 1)).view(torch.float32)

    @staticmethod
    def forward(ctx, x, bits):
        ctx.bits = bits
        return Round._round(x, bits)

    @staticmethod
    def backward(ctx, g):
        return Round._round(g, ctx.bits), None


def rounded(x: torch.Tensor, bits: int) -> torch.Tensor:
    return Round.apply(x.float(), bits).to(x.dtype)


def conv_forward(kind: str, bits: int = 7):
    """A replacement of layers.Conv.forward: `fp32` sums in fp32 on the
    bf16 operands, `fp16` computes in fp16; `round` rounds the operands,
    the output and their gradients to `bits` mantissa bits."""
    from vodascheduler_tpu_torch.models.layers import pad_same

    def forward(self, x):
        dt = x.dtype
        w = self.weight.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        x = pad_same(x, self.kernel, self.stride)
        if kind in ("fp32", "fp16"):
            cdt = getattr(torch, f"float{kind[2:]}")
            return F.conv2d(x.to(cdt), w.to(cdt),
                            None if bias is None else bias.to(cdt),
                            self.stride).to(dt)
        y = F.conv2d(rounded(x, bits), rounded(w, bits), bias, self.stride)
        return rounded(y, bits)
    return forward


def bn_bf16_forward(self, x):
    """resnet.BatchNorm's forward on NCHW `x`, in x's dtype."""
    mean, var, scale, bias = (t.to(x.dtype)[:, None, None] for t in (
        self.mean, self.var, self.scale, self.bias))
    return (x - mean) * torch.rsqrt(var + self.eps) * scale + bias


@contextlib.contextmanager
def variant(module, name: str):
    """The bf16 pass of `module` under variant `name`; TF32 off unless the
    variant is `cudnn`."""
    from vodascheduler_tpu_torch.models import layers, resnet

    patches = []  # (owner, attribute, replacement)
    if name in ("fp32_conv", "fp16_all"):
        patches.append((layers.Conv, "forward",
                        conv_forward(name[:4])))
    elif name.endswith("_all") and name[0] == "m":
        patches.append((layers.Conv, "forward",
                        conv_forward("round", int(name[1]))))
    elif name.endswith("_init"):
        init = conv_forward("round", int(name[1]))
        patches.append((module.conv_init, "forward",
                        init.__get__(module.conv_init)))
    elif name == "bn_bf16":
        patches.append((resnet.BatchNorm, "forward", bn_bf16_forward))
    saved = [(o, a, o.__dict__.get(a)) for o, a, _ in patches]
    for owner, attr, fn in patches:
        setattr(owner, attr, fn)
    tf32 = (contextlib.nullcontext() if name == "cudnn" else no_tf32())
    try:
        with tf32:
            yield
    finally:
        for owner, attr, old in saved:
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)


@contextlib.contextmanager
def no_tf32():
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def loss_and_grads(bundle, module, batch):
    module.zero_grad(set_to_none=True)
    loss = bundle.loss_fn(module, batch)
    loss.backward()
    grads = {n: p.grad.float() for n, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    return loss.item(), grads


def gaps(loss, grads, loss_t, grads_t) -> dict:
    gap = {n: ((grads[n] - grads_t[n]).abs().max()
               / grads_t[n].abs().max().clamp_min(1e-30)).item()
           for n in grads_t}
    worst = sorted(gap, key=gap.get)[-3:]
    return {"loss": abs(loss - loss_t) / abs(loss_t), "grad": gap[worst[-1]],
            "worst": [[n, gap[n]] for n in reversed(worst)]}


def run_seed(seed: int, batch_size: int) -> dict:
    import dataclasses

    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession

    session = TrainSession(get_model("resnet50"), 1,
                           global_batch_size=batch_size, seed=seed)
    batch = session.make_batch()
    module = session.module
    twin = type(module)(dataclasses.replace(module.cfg, dtype="float32"),
                        device=module.conv_init.weight.device)
    twin.load_state_dict(module.state_dict())
    with no_tf32():
        loss_t, grads_t = loss_and_grads(session.bundle, twin, batch)
    del twin
    out = {}
    for name in SOUND + FAULTY + OTHER:
        with variant(module, name):
            out[name] = gaps(*loss_and_grads(session.bundle, module, batch),
                             loss_t, grads_t)
        print(f"seed {seed} {name}: loss {out[name]['loss']:.6g} grad "
              f"{out[name]['grad']:.6g} worst {out[name]['worst']}",
              flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    readings = {n: [] for n in SOUND + FAULTY + OTHER}
    for seed in map(int, args.seeds.split(",")):
        for name, r in run_seed(seed, args.batch).items():
            readings[name].append(r["grad"])
    print(json.dumps({
        "batch": args.batch, "grad_gap": readings,
        "mean": {n: statistics.fmean(r) for n, r in readings.items()},
        "sound_max": max(max(readings[n]) for n in SOUND),
        "faulty_min": {n: min(readings[n]) for n in FAULTY},
        "other_max": {n: max(readings[n]) for n in OTHER}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
