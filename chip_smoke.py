"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: the CUDA kernels of vodascheduler_tpu_torch/ops/csrc, by nvcc;
     fails if ptxas spills registers in the forward, dQ or dK/dV kernel at
     D=64 (the main path), and logs the spills at D=128;
  3. kernels: each kernel against its plain PyTorch version at llama_350m's
     attention shapes (B=8, H=16, S=2048, D=64, bf16, causal), at
     mixtral_small's (H=10), at a ragged S=1000, at D=128, at a query slice
     with q_offset and at a ragged query slice with q_offset, and at head
     widths 16 and 96, which the kernels take zero-padded to 64 and 128 (as
     the attention operator sends them) against the plain versions at the
     true width; then each timed
     with CUDA events beside its plain version, the PyTorch library call that
     computes the same function, and its bound on the card, and dQ then
     dK/dV timed as one backward beside the library's backward; the padded
     widths' forward and backward timed beside the library's;
  4. slice: llama_350m at full width in a TrainSession on the card — one
     forward and backward through the kernels against the plain attention
     (the step-0 loss, the hidden state before the final norm, every
     parameter's gradient), 5 AdamW steps on one batch (finite, falling
     loss), then one step with the launch counters reset, which must
     launch K1 48, K2 24, K3 24 times;
  5a. llama_350m_af (Adafactor, the dots_attn remat policy) at full width
     and depth in a TrainSession: the same comparison with the plain
     attention, 5 Adafactor steps (finite, falling loss), one counted step
     that must launch K1 24 (the policy keeps the attention output, so the
     recompute does not run K1 again), K2 24, K3 24 times; the optimizer
     step and the time its per-leaf layout takes; one checkpoint's bytes
     and seconds;
  5b. the job through the supervisor, in subprocesses on the card: a
     llama_350m_af spec (B=8, 3 steps per epoch, 3 epochs) is stopped by
     SIGTERM once its epoch-0 checkpoint has committed (exit 3, a
     checkpoint at the step it reached), restarted (``resumed at step N
     on 1 chips``, exit 0 at step 9, every kernel launched), three CSV
     rows of 1 worker and batch 8, finite epoch losses, and the step-9
     loss within 1e-3 of an uninterrupted 9-step TrainSession's;
  5c. mixtral_small (the MoE flagship: 12 layers, H=10, 8 experts, top 2,
     the gather dispatch, full remat, AdamW) at full width and depth: the
     comparison with the plain attention with the kernel pass's routing
     replayed in the plain pass (routing is discrete, and a bf16
     difference would flip near-tied experts), the share of decisions the
     plain pass would have made otherwise and of token-expert choices
     dropped by capacity at step 0, 5 steps, one counted step that must
     launch K1 24, K2 12, K3 12 times; step ms, tokens/s, peak memory and
     MFU (active parameters);
  5d. mixtral_small_af (Adafactor, dots_attn): the same, launches 12/12/12,
     the Adafactor step and its leaf gather, one checkpoint;
  5e. the hardware bench (runtime/hwbench.py, two-point differencing):
     mixtral_small's step under the gather, routed and dense dispatches
     and the mixtral_small_af knobs, llama_350m's step, with MFU, and the
     kernels against the plain attention at mixtral_small's shape;
  6. the scheduler on the card: the port's Scheduler, its GPU LocalBackend
     (the card counted), AdmissionService, the real clock and
     ElasticTiresias take two llama_350m_af jobs (B=8, 5 steps per epoch;
     A 4 epochs, B 2). A is submitted; at its first checkpoint the queue-0
     threshold and the lease are lowered so that A is demoted, and B is
     submitted and preempts it (SIGTERM, exit 3 with a checkpoint); B runs
     only after A's process has exited, and completes; A resumes (``resumed
     at step N on 1 chips``, N >= 5) and completes. One CSV row per epoch
     each, K1, K2 and K3 launched by every supervisor process, and A's
     second-epoch loss equal to B's (1e-3 relative: the same batches at the
     same steps). Printed: each job's submit -> first step and submit ->
     end, A's SIGTERM -> exit and restart -> first step, B's wait, the
     makespan, the passes and their median decide time;
  7. one JSON line of the kernels, then the device line last.

Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TPU_SRC = "vodascheduler_tpu/ops/flash_attention.py"
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a) -> None:
    print(*a, flush=True)


# Kernels that must not spill registers at the main path's head_dim.
SPILL_FREE = ("flash_fwd", "flash_dq", "flash_dkv")
MAIN_HEAD_DIM = 64


def ptxas_spills(text: str) -> dict:
    """{(kernel, head_dim): bytes of spill stores + loads} from the log of
    `nvcc -Xptxas -v` (a "Function properties for <mangled name>" line,
    then its "... bytes spill stores, ... bytes spill loads" line)."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            k = re.search(r"(flash_\w+?)_kernelILi(\d+)E", fn)
            if k:
                out[(k.group(1), int(k.group(2)))] = (int(m.group(1))
                                                      + int(m.group(2)))
            fn = None
    return out


def spill_faults(spills: dict) -> list:
    """What the spill check refuses: a spill, or no ptxas line at all, for
    a kernel of SPILL_FREE at MAIN_HEAD_DIM."""
    faults = []
    for name in SPILL_FREE:
        got = spills.get((name, MAIN_HEAD_DIM))
        if got is None:
            faults.append(f"{name} D={MAIN_HEAD_DIM}: no ptxas spill line")
        elif got:
            faults.append(f"{name} D={MAIN_HEAD_DIM}: {got} bytes spilled")
    return faults


def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median milliseconds of one call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def attn_pairs(Sq: int, Sk: int, causal: bool, q_off: int) -> int:
    """(query, key) pairs the causal mask leaves, the work of one product."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, q_off + r + 1) for r in range(Sq))


def bound(n_products: int, n_tensors: int, n_stats: int, B, H, Sq, Sk, D,
          causal, q_off):
    """(ms, 'operations' | 'bytes'): the least time on the card."""
    flops = n_products * 2 * B * H * attn_pairs(Sq, Sk, causal, q_off) * D
    nbytes = n_tensors * B * max(Sq, Sk) * H * D * 2 + n_stats * B * H * Sq * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def rel_err(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def abs_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def row_err(got, ref) -> float:
    """Largest ||got - ref|| / ||ref|| over the rows of the last axis: every
    row is held to its own size, so an error confined to a few rows or to
    rows whose values are small (the late rows of a causal product) still
    shows. A row whose true value is near 0 by cancellation (dq of the
    first query, which sees one key) is held to 1e-3 of the largest row."""
    diff = (got.float() - ref.float()).norm(dim=-1)
    size = ref.float().norm(dim=-1)
    return (diff / size.clamp_min(1e-3 * size.max().item() + 1e-30)
            ).max().item()


# The bars of the kernel check. bf16 rounding of the output and of P (and
# dS) before their products keeps a row's relative error near 2^-9 ≈ 2e-3;
# the bars leave room for that and reject a kernel that drops one 64-row
# tile from the sum of a 2048-long row.
LIMITS = {"o_row": 1e-2, "lse": 1e-2, "delta": 3e-2, "dq_row": 1.5e-2,
          "dk_row": 1.5e-2, "dv_row": 1.5e-2}


def kernel_errors(fa, name, shape):
    """Errors of each kernel against its plain version at one shape, logged
    with the bars they break: (errors, ["name=err>bar", ...]). A head width
    the kernels are not built for goes in as the attention operator sends
    it: zero-padded along D to the kernels' width, with D's own scale, and
    cut back to D; the plain versions run at D itself."""
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(1)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, Sk, H, D, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, Sk, H, D, generator=g, device="cuda").bfloat16()
    do = torch.randn(B, Sq, H, D, generator=g, device="cuda").bfloat16()
    width, scale = fa.kernel_head_dim(D), D ** -0.5
    qp, kp, vp, dop = (fa.pad_head(t, width) for t in (q, k, v, do))
    o, lse = fa.flash_fwd(qp, kp, vp, causal, q_off, scale=scale)
    o = o[..., :D]
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    dq, delta = fa.flash_dq(qp, kp, vp, fa.pad_head(o, width), dop, lse,
                            causal, q_off, scale=scale)
    dq = dq[..., :D]
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal,
                                              q_off)
    dk, dv = fa.flash_dkv(qp, kp, vp, dop, lse, delta_ref, causal, q_off,
                          scale=scale)
    dk, dv = dk[..., :D], dv[..., :D]
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta_ref,
                                            causal, q_off)
    torch.cuda.synchronize()
    errs = {"o_row": row_err(o, o_ref), "o": abs_err(o, o_ref),
            "lse": abs_err(lse, lse_ref), "delta": abs_err(delta, delta_ref),
            "dq_row": row_err(dq, dq_ref), "dk_row": row_err(dk, dk_ref),
            "dv_row": row_err(dv, dv_ref),
            "dq": rel_err(dq, dq_ref), "dk": rel_err(dk, dk_ref),
            "dv": rel_err(dv, dv_ref), "dq_abs": abs_err(dq, dq_ref),
            "dk_abs": abs_err(dk, dk_ref), "dv_abs": abs_err(dv, dv_ref)}
    bad = [f"{n}={errs[n]:.3g}>{lim}" for n, lim in LIMITS.items()
           if not errs[n] <= lim]
    log(f"kernels[{name}] B={B} H={H} Sq={Sq} Sk={Sk} D={D} "
        f"causal={causal} q_off={q_off} "
        + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + (" FAIL " + ",".join(bad) if bad else " ok"))
    del q, k, v, do, qp, kp, vp, dop, o, lse, o_ref, lse_ref, dq, dq_ref
    del dk, dv
    torch.cuda.empty_cache()
    return errs, bad


def check_kernels(fa, cases):
    """Each kernel against its plain version at every case; returns the
    errors at the main shape and fails after reporting every case."""
    failures, main = [], {}
    for name, shape in cases.items():
        errs, bad = kernel_errors(fa, name, shape)
        failures += [f"{name}: {b}" for b in bad]
        if name == "main":
            main = errs
    if failures:
        raise SystemExit("kernel check failed: " + "; ".join(failures))
    return main


def library_times(q, k, v, do, causal):
    """PyTorch's own flash attention on the same inputs, timed as a
    yardstick only (the port never calls it): (fwd_ms, bwd_ms)."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=causal))
    qc, kc, vc, doc = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    out, lse, cq, ck, mq, mk, seed, off = \
        torch.ops.aten._scaled_dot_product_flash_attention(
            qc, kc, vc, 0.0, causal)[:8]
    bwd = cuda_ms(lambda: torch.ops.aten
                  ._scaled_dot_product_flash_attention_backward(
                      doc, qc, kc, vc, out, lse, cq, ck, mq, mk, 0.0, causal,
                      seed, off))
    return fwd, bwd


def time_kernels(fa, shape, errs):
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(2)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, Sk, H, D, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, Sk, H, D, generator=g, device="cuda").bfloat16()
    do = torch.randn(B, Sq, H, D, generator=g, device="cuda").bfloat16()
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    _, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    rows = {
        "flash_fwd": dict(
            ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, q_off)),
            plain_ms=cuda_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal, q_off), reps=10),
            b=bound(2, 4, 1, *shape), err=max(errs["o"], errs["lse"]),
            replaces=f"{TPU_SRC}:114",
            source="vodascheduler_tpu_torch/ops/csrc/flash_fwd.cu"),
        "flash_dq": dict(
            ms=cuda_ms(lambda: fa.flash_dq(q, k, v, o, do, lse, causal,
                                           q_off)),
            plain_ms=cuda_ms(lambda: fa.flash_dq_reference(
                q, k, v, o, do, lse, causal, q_off), reps=10),
            b=bound(3, 6, 2, *shape), err=errs["dq_abs"],
            replaces=f"{TPU_SRC}:215",
            source="vodascheduler_tpu_torch/ops/csrc/flash_dq.cu"),
        "flash_dkv": dict(
            ms=cuda_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal,
                                            q_off)),
            plain_ms=cuda_ms(lambda: fa.flash_dkv_reference(
                q, k, v, do, lse, delta, causal, q_off), reps=10),
            b=bound(4, 6, 2, *shape),
            err=max(errs["dk_abs"], errs["dv_abs"]),
            replaces=f"{TPU_SRC}:260",
            source="vodascheduler_tpu_torch/ops/csrc/flash_dkv.cu"),
    }
    lib_fwd, lib_bwd = library_times(q, k, v, do, causal)
    rows["flash_fwd"]["library_ms"] = lib_fwd
    # The library's backward computes dq, dk and dv in one call; it stands
    # beside both backward kernels.
    rows["flash_dq"]["library_ms"] = lib_bwd
    rows["flash_dkv"]["library_ms"] = lib_bwd
    for name, r in rows.items():
        log(f"time[{name}] kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']} bound_ms={r['b'][0]:.4f} "
            f"({r['b'][1]}) roofline_share={r['b'][0] / r['ms']:.3f}")
    bwd_ms = cuda_ms(backward_call(fa, q, k, v, o, do, lse, causal, q_off))
    b = bound(7, 8, 1, *shape)
    log(f"time[backward] kernel_ms={bwd_ms:.4f} (flash_dq then flash_dkv) "
        f"library_ms={lib_bwd:.4f} bound_ms={b[0]:.4f} ({b[1]}) "
        f"library_over_kernels={lib_bwd / bwd_ms:.3f}")
    return rows


def time_padded(fa, name, shape):
    """A head width the kernels take zero-padded, timed as the attention
    operator runs it (pad, kernel, cut): the forward, and the backward (K2
    then K3), beside the library calls at the same width. Logged."""
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(2)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .bfloat16() for S in (Sq, Sk, Sk, Sq))
    o, lse = fa.padded_forward(fa.flash_fwd, q, k, v, causal, q_off)
    fwd_ms = cuda_ms(lambda: fa.padded_forward(fa.flash_fwd, q, k, v, causal,
                                               q_off))
    bwd_ms = cuda_ms(lambda: fa.padded_backward(
        fa.flash_dq, fa.flash_dkv, q, k, v, o, do, lse, causal, q_off))
    lib_fwd, lib_bwd = library_times(q, k, v, do, causal)
    log(f"time[{name}] D={D} padded_to={fa.kernel_head_dim(D)} "
        f"forward_ms={fwd_ms:.4f} library_fwd_ms={lib_fwd:.4f} "
        f"backward_ms={bwd_ms:.4f} library_bwd_ms={lib_bwd:.4f} "
        f"bound_fwd_ms={bound(2, 4, 1, *shape)[0]:.4f} "
        f"bound_bwd_ms={bound(7, 8, 1, *shape)[0]:.4f}")


def backward_call(fa, q, k, v, o, do, lse, causal, q_off):
    """The port's whole attention backward, as the attention operator's
    backward runs it: K2 (dq and δ), then K3 (dk, dv) on that δ."""
    def call():
        _, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
        return fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    return call


def forward_backward(bundle, module, batch):
    """One forward and backward of the loss at the current weights:
    (loss, hidden state before the final norm, {parameter: gradient})."""
    hidden = []
    hook = module.final_norm.register_forward_pre_hook(
        lambda _m, args: hidden.append(args[0].detach()))
    module.zero_grad(set_to_none=True)
    loss = bundle.loss_fn(module, batch)
    loss.backward()
    hook.remove()
    grads = {n: p.grad for n, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    return loss.item(), hidden[0], grads


class RoutingReplay:
    """Routing pinned across the two passes of an MoE model's comparison.

    While installed (`moe_dispatch.top_k_gating` replaced), the first pass
    records each layer's top-k experts and gates, and the second routes
    each layer by the first pass's experts, with gate values from its own
    probabilities. Layers are told apart by a hook on each MoE block, so a
    recompute under checkpoint replays its own layer's choice."""

    def __init__(self, module):
        from vodascheduler_tpu_torch.ops import moe_dispatch
        self.dispatch = moe_dispatch
        self.layer, self.replay = None, False
        self.chosen, self.gates, self.differ = {}, {}, {}
        self.hooks = [layer.moe.register_forward_pre_hook(
            lambda _m, _a, i=i: setattr(self, "layer", i))
            for i, layer in enumerate(module.layers)]
        self.original = moe_dispatch.top_k_gating
        moe_dispatch.top_k_gating = self.gating

    def gating(self, probs, top_k, eps=1e-9):
        own = self.dispatch.top_k_indices(probs, top_k)
        if self.replay:
            idx = self.chosen[self.layer]
            if self.layer not in self.differ:  # the forward, not a recompute
                self.differ[self.layer] = int(
                    (own.sort(-1)[0] != idx.sort(-1)[0]).any(-1).sum())
        else:
            idx = self.chosen.setdefault(self.layer, own)
        gate = self.dispatch.gates_at(probs, idx, eps)
        if not self.replay:
            self.gates.setdefault(self.layer, gate.detach())
        return gate

    def remove(self) -> None:
        self.dispatch.top_k_gating = self.original
        for h in self.hooks:
            h.remove()

    def shares(self, cfg) -> dict:
        """The share of the second pass's decisions that its own
        probabilities would have made otherwise, and the share of the first
        pass's token-expert choices dropped by capacity."""
        tokens = next(iter(self.chosen.values())).shape[:-1].numel()
        dropped = [self.dispatch.dropped_share(g, cfg.capacity_factor,
                                               cfg.top_k)
                   for g in self.gates.values()]
        return {"routing_differs": sum(self.differ.values())
                / (tokens * len(self.differ)),
                "dropped_at_step0": statistics.mean(dropped)}


def slice_gaps(bundle, module, batch):
    """What attention moves at init, through the kernels against the plain
    O(S²) attention on the card: the hidden state before the final norm
    (largest relative error of a token's row) and every parameter's
    gradient (largest ||g - g_plain|| / ||g_plain||). An MoE model's plain
    pass routes as the kernel pass did (RoutingReplay)."""
    kernel_attn, cfg = module.attn_fn, module.cfg
    replay = RoutingReplay(module) if bundle.num_experts else None
    try:
        loss_k, h_k, g_k = forward_backward(bundle, module, batch)
        # The plain pass runs under full remat: a policy moves no number,
        # and under "dots" the plain attention's S×S products of every
        # layer would be kept for the backward.
        module.attn_fn = None
        module.cfg = dataclasses.replace(cfg, remat_policy=None)
        if replay is not None:
            replay.replay = True
        loss_p, h_p, g_p = forward_backward(bundle, module, batch)
    finally:
        module.attn_fn, module.cfg = kernel_attn, cfg
        if replay is not None:
            replay.remove()
    grad = {n: ((g_k[n] - g_p[n]).norm() / g_p[n].norm().clamp_min(1e-30))
            .item() for n in g_p}
    worst = max(grad, key=grad.get)
    gaps = {"loss": abs(loss_k - loss_p) / abs(loss_p),
            "hidden_row": row_err(h_k, h_p), "grad": grad[worst],
            "grad_param": worst, "finite": math.isfinite(loss_k)}
    if replay is not None:
        gaps.update(replay.shares(cfg))
    return gaps


# The bars of the slice's comparison with the plain attention. bf16
# rounding inside attention, carried through 24 layers, leaves the sound
# kernels at hidden_row 0.022 and grad 0.031 (q_proj of the first layer) at
# llama_350m on an H100; a K1 that drops one K/V tile from the last query
# tile reads 0.25 and 0.063 (scripts/torch_planted_fault.py).
SLICE_LIMITS = {"loss": 2e-2, "hidden_row": 5e-2, "grad": 5e-2}


def check_slice(gaps) -> list:
    """The bars of SLICE_LIMITS that `gaps` breaks, logged."""
    bad = [f"{n}={gaps[n]:.3g}>{lim}" for n, lim in SLICE_LIMITS.items()
           if not gaps[n] <= lim]
    if not gaps["finite"]:
        bad.append("loss not finite")
    log("slice kernels vs plain attention: "
        + " ".join(f"{n}={v:.3g}" if isinstance(v, float) else f"{n}={v}"
                   for n, v in gaps.items())
        + (" FAIL " + ",".join(bad) if bad else " ok"))
    return bad


def train_and_count(fa, name, session, batch, want):
    """5 steps on `batch` (finite, falling loss), then one counted step
    that must launch each kernel as often as `want` says; returns the
    counts."""
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(session.train_step(batch).item())
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"{name} losses={[round(x, 6) for x in losses]} "
        f"step_ms={[round(x, 3) for x in step_ms]}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"{name}: training loss is not finite and falling")

    # The path, counted: one step with every count at 0 before it.
    fa.reset_launches()
    t0 = time.perf_counter()
    loss = session.train_step(batch).item()
    torch.cuda.synchronize()
    step_ms.append(1e3 * (time.perf_counter() - t0))
    counts = dict(fa.launches)
    log(f"{name} counted step loss={loss:.6f} launches={counts} want={want}")
    if counts != want or not math.isfinite(loss):
        raise SystemExit(f"{name}: the training step did not launch the "
                         "kernels as expected")
    steady = statistics.median(step_ms[1:])
    tokens = session.global_batch_size * session.bundle.seq_len
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{name} step_ms={steady:.3f} (median of steps 2-6) "
        f"tokens_per_s={tokens / steady * 1e3:.1f} peak_mem_gb={peak:.2f} "
        f"mfu={step_mfu(session, steady):.4f}")
    return counts


def step_mfu(session, step_ms: float) -> float:
    """MFU of a step of `step_ms` by hwbench's convention (active
    parameters for an MoE model) against the card's dense bf16 peak."""
    from vodascheduler_tpu_torch.runtime import hwbench

    _, _, flops = hwbench.model_step_flops(session.bundle, session.module,
                                           session.global_batch_size)
    return flops / (step_ms / 1e3) / hwbench.peak_flops_per_device()


def build_slice(model: str):
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession

    bundle = get_model(model)
    session = TrainSession(bundle, 1, global_batch_size=8)
    from vodascheduler_tpu_torch.runtime import hwbench

    n_params, active, _ = hwbench.model_step_flops(bundle, session.module, 8)
    if bundle.num_experts:
        cfg = bundle.cfg
        log(f"slice: {model} active_params={active} heads={cfg.num_heads} "
            f"experts={cfg.num_experts} top_k={cfg.top_k} "
            f"dispatch={cfg.dispatch} capacity_factor={cfg.capacity_factor}")
    log(f"slice: {model} params={n_params} layers={bundle.cfg.num_layers} "
        f"dim={bundle.cfg.dim} B=8 S={bundle.seq_len} "
        f"optimizer={bundle.optimizer} remat_policy={bundle.cfg.remat_policy} "
        f"device={session.device}")
    batch = session.make_batch()
    if check_slice(slice_gaps(bundle, session.module, batch)):
        raise SystemExit(f"{model}: the step through the kernels disagrees "
                         "with the plain attention")
    return session, batch


def run_slice(fa, model="llama_350m", tag="slice"):
    session, batch = build_slice(model)
    L = session.bundle.cfg.num_layers
    return train_and_count(fa, tag, session, batch,
                           {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L})


def run_benches():
    """Phase 5e: the hardware bench's one-card points. Printed; a point
    that fails fails the run."""
    from vodascheduler_tpu_torch.runtime import hwbench

    k = dict(k_small=2, k_big=6, reps=3)
    moe = hwbench.bench_moe_dispatch(8, **k)
    gather, af = moe["gather"], moe["gather_af"]
    log(f"hwbench dispatch mixtral_small B=8 S=2048 step_ms "
        f"gather={gather['step_time_ms']:.3f} "
        f"routed={moe['routed_step_ms']:.3f} "
        f"dense={moe['dense_step_ms']:.3f} "
        f"gather_af={af['step_time_ms']:.3f} "
        f"dense_over_gather={moe['gather_speedup_vs_dense']:.3f}")
    llama = hwbench.bench_model_step("llama_350m", 8, **k).as_dict()
    for name, r in (("llama_350m", llama), ("mixtral_small", gather),
                    ("mixtral_small_af", af)):
        log(f"hwbench step {name} step_ms={r['step_time_ms']:.3f} "
            f"tokens_per_s={r['tokens_per_sec']:.1f} "
            f"mfu={r['mfu']:.4f} tflops={r['achieved_tflops']:.2f} "
            f"params={r['num_params']} active={r['num_params_active']} "
            f"peak_mem_gb={r['peak_memory_bytes'] / 1e9:.2f}")
    point = hwbench.bench_attention_point(8, 2048, heads=10, **k)
    log(f"hwbench attention B=8 S=2048 H=10 D=64 fwd+bwd "
        f"kernels_ms={point['flash_ms']:.4f} plain_ms={point['plain_ms']:.4f} "
        f"plain_over_kernels={point['flash_speedup']:.2f}")


def adafactor_times(session) -> None:
    """The optimizer step, and the part of it that gathers the gradients
    into the reference's leaves (stack, transpose): the cost of the
    per-leaf layout, by CUDA events."""
    from vodascheduler_tpu_torch.runtime.optim import to_leaf

    opt = session.optimizer
    state = {p: {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in st.items()} for p, st in opt.state.items()}
    params = [p.detach().clone() for p in session.module.parameters()]
    step_ms = cuda_ms(opt.step, warmup=1, reps=5)
    gather_ms = cuda_ms(lambda: [to_leaf(g, [p.grad for p in g["params"]])
                                 for g in opt.param_groups])
    # The timed steps changed the weights and the statistics: put both back.
    with torch.no_grad():
        for p, saved in zip(session.module.parameters(), params):
            p.copy_(saved)
    opt.state.update(state)
    log(f"adafactor optimizer_step_ms={step_ms:.4f} "
        f"leaf_gather_ms={gather_ms:.4f} ({len(opt.param_groups)} leaves)")


def run_af_slice(fa, model="llama_350m_af", tag="af"):
    session, batch = build_slice(model)
    L = session.bundle.cfg.num_layers
    counts = train_and_count(fa, tag, session, batch,
                             {"flash_fwd": L, "flash_dq": L, "flash_dkv": L})
    adafactor_times(session)
    ckpt_dir = os.path.join(REPO, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    session.save(ckpt_dir, wait=True)
    save_s = time.perf_counter() - t0
    step, nbytes, copy_s, write_s = session.last_save
    log(f"{tag} checkpoint step={step} bytes={nbytes} save_s={save_s:.3f} "
        f"host_copy_s={copy_s:.3f} write_s={write_s:.3f}")
    shutil.rmtree(ckpt_dir)
    return counts


JOB_STEPS_PER_EPOCH, JOB_EPOCHS = 3, 3


def _supervisor(workdir: str, tag: str):
    out = open(os.path.join(workdir, f"{tag}.out"), "w")
    err = open(os.path.join(workdir, f"{tag}.err"), "w")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("VODA_FORCE_CPU_DEVICES", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "vodascheduler_tpu_torch.runtime.supervisor",
         "--workdir", workdir, "--num-chips", "1"],
        stdout=out, stderr=err, cwd=REPO, env=env)
    out.close()
    err.close()
    return proc


def _text(workdir: str, name: str) -> str:
    with open(os.path.join(workdir, name)) as f:
        return f.read()


def _wait(proc, workdir: str, tag: str, cond, what: str,
          timeout: float = 300.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            proc.wait()
            raise SystemExit(
                f"job: {tag} exited ({proc.returncode}) or timed out before "
                f"{what}\n{_text(workdir, f'{tag}.out')[-2000:]}\n"
                f"{_text(workdir, f'{tag}.err')[-4000:]}")
        time.sleep(0.01)


def _finish(proc, workdir: str, tag: str, timeout: float = 300.0) -> int:
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SystemExit(f"job: {tag} did not exit within {timeout} s")
    finally:
        log(f"job[{tag}] stdout: " + " | ".join(
            _text(workdir, f"{tag}.out").splitlines()))


def _epoch_losses(text: str) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^epoch (\d+) loss (\S+)$", text, re.M)}


def run_job_cycle():
    """Phase 5b: SIGTERM -> exit 3 -> resume -> exit 0, checked against an
    uninterrupted TrainSession."""
    from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        read_epoch_csv,
    )
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession
    from vodascheduler_tpu_torch.runtime.checkpoint import latest_step

    workdir = os.path.join(REPO, "build", "chip_smoke_job")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    name = "llama_350m_af_job"
    spec = JobSpec(name=name, model="llama_350m_af", global_batch_size=8,
                   steps_per_epoch=JOB_STEPS_PER_EPOCH,
                   config=JobConfig(epochs=JOB_EPOCHS))
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)
    ckpt_dir = os.path.join(workdir, "ckpt")
    total = JOB_STEPS_PER_EPOCH * JOB_EPOCHS

    first = _supervisor(workdir, "first")
    epoch0 = os.path.join(ckpt_dir, f"step_{JOB_STEPS_PER_EPOCH:010d}")
    _wait(first, workdir, "first", lambda: os.path.isdir(epoch0),
          "its epoch-0 checkpoint")
    t0 = time.monotonic()
    first.send_signal(signal.SIGTERM)
    rc = _finish(first, workdir, "first")
    sigterm_s = time.monotonic() - t0
    out1 = _text(workdir, "first.out")
    saved = latest_step(ckpt_dir)
    m = re.search(r"^checkpoint step (\d+) bytes (\d+) host_copy_s (\S+) "
                  r"write_s (\S+)$", out1, re.M)
    if rc != 3 or m is None or int(m.group(1)) != saved:
        raise SystemExit(f"job: SIGTERM gave exit {rc} and checkpoint "
                         f"{m and m.group(1)} (latest {saved}); want exit 3 "
                         "and a checkpoint at the step reached\n"
                         + _text(workdir, "first.err")[-3000:])
    log(f"job SIGTERM->exit_s={sigterm_s:.3f} exit={rc} checkpoint_step="
        f"{saved} checkpoint_bytes={m.group(2)} host_copy_s={m.group(3)} "
        f"write_s={m.group(4)}")

    t0 = time.monotonic()
    second = _supervisor(workdir, "second")
    _wait(second, workdir, "second",
          lambda: "warmup step" in _text(workdir, "second.out"),
          "its first step")
    first_step_s = time.monotonic() - t0
    rc = _finish(second, workdir, "second")
    out2 = _text(workdir, "second.out")
    m = re.search(r"^kernel launches (.*)$", out2, re.M)
    fa_launches = json.loads(m.group(1)) if m else None
    resumed = f"resumed at step {saved} on 1 chips" in out2
    losses = {**_epoch_losses(out1), **_epoch_losses(out2)}
    rows = read_epoch_csv(os.path.join(workdir, "metrics", f"{name}.csv"))
    log(f"job restart->first_step_s={first_step_s:.3f} exit={rc} "
        f"resumed={resumed} launches={fa_launches} epoch_losses={losses} "
        f"csv_rows={[(r['epoch'], r['workers'], r['global_batch_size']) for r in rows]}")
    bad = []
    if rc != 0 or not resumed:
        bad.append(f"restart gave exit {rc}, resumed line {resumed}")
    if not fa_launches or min(fa_launches.values()) < 1:
        bad.append(f"the restarted job launched {fa_launches}")
    if sorted(losses) != list(range(JOB_EPOCHS)) or not all(
            math.isfinite(x) for x in losses.values()):
        bad.append(f"epoch losses {losses}")
    if ([r["epoch"] for r in rows] != [str(e) for e in range(JOB_EPOCHS)]
            or any(r["workers"] != "1" or r["global_batch_size"] != "8"
                   for r in rows)):
        bad.append(f"csv rows {rows}")
    if bad:
        raise SystemExit("job: " + "; ".join(bad) + "\n"
                         + _text(workdir, "second.err")[-3000:])

    session = TrainSession(get_model("llama_350m_af"), 1, global_batch_size=8)
    straight = session.run_steps(total)
    gap = abs(losses[JOB_EPOCHS - 1] - straight) / abs(straight)
    log(f"job step-{total} loss supervisor={losses[JOB_EPOCHS - 1]:.6f} "
        f"uninterrupted={straight:.6f} rel_gap={gap:.3g} (bar 1e-3)")
    del session
    shutil.rmtree(workdir)
    if not gap <= 1e-3:
        raise SystemExit("job: the resumed run's loss is not the "
                         "uninterrupted run's")


SCHED_STEPS_PER_EPOCH, SCHED_EPOCHS = 5, {"a": 4, "b": 2}
# Launch-count keys of K1, K2 and K3 in a supervisor's exit line.
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def run_scheduler():
    """Phase 6: the port's scheduler drives two llama_350m_af jobs on the
    card through its GPU LocalBackend: submit -> run -> preempt
    (checkpoint) -> resume -> complete. Returns the kernel launches the
    three supervisor processes report at exit, summed."""
    from vodascheduler_tpu_torch.algorithms import elastic_tiresias, tiresias
    from vodascheduler_tpu_torch.allocator import ResourceAllocator
    from vodascheduler_tpu_torch.cluster.local import LocalBackend
    from vodascheduler_tpu_torch.common.clock import Clock
    from vodascheduler_tpu_torch.common.events import EventBus
    from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
    from vodascheduler_tpu_torch.common.store import JobStore
    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        read_epoch_csv,
    )
    from vodascheduler_tpu_torch.placement import PlacementManager
    from vodascheduler_tpu_torch.scheduler import Scheduler
    from vodascheduler_tpu_torch.service import AdmissionService

    class Backend(LocalBackend):
        """Times every spawn and every stop."""

        def __init__(self, workdir):
            super().__init__(workdir)
            self.spawns, self.stops = [], []

        def _spawn(self, spec, num_chips):
            self.spawns.append((spec.name, time.monotonic()))
            return super()._spawn(spec, num_chips)

        def _stop_proc(self, name):
            proc, t0 = self._procs.get(name), time.monotonic()
            super()._stop_proc(name)
            if proc is not None:
                self.stops.append((name, proc.popen.returncode, t0,
                                   time.monotonic()))

    workdir = os.path.join(REPO, "build", "chip_smoke_sched")
    shutil.rmtree(workdir, ignore_errors=True)
    old_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO + os.pathsep + (old_path or "")
    os.environ.pop("VODA_FORCE_CPU_DEVICES", None)
    backend = Backend(workdir)
    if backend.chips != 1:
        raise SystemExit(f"sched: the backend counted {backend.chips} cards; "
                         "the phase needs exactly one")
    store, bus, clock = JobStore(), EventBus(), Clock()
    sched = Scheduler("h100", backend, store, ResourceAllocator(store), clock,
                      bus=bus, placement_manager=PlacementManager("h100"),
                      algorithm="ElasticTiresias", rate_limit_seconds=0.5)
    admission = AdmissionService(store, bus, clock)
    names, submitted, first_steps, done = {}, {}, {}, {}

    def log_text(job):
        job_dir = os.path.join(workdir, names[job])
        return (_text(job_dir, "supervisor.log")
                if os.path.exists(os.path.join(job_dir, "supervisor.log"))
                else "")

    def observe():
        now = time.monotonic()
        for job in names:
            n = log_text(job).count("warmup step")
            if n > len(first_steps.setdefault(job, [])):
                first_steps[job].append(now)
            if job not in done and store.get_job(
                    names[job]).status.value in ("Completed", "Failed"):
                done[job] = now

    def wait(cond, what, timeout=600.0):
        # The real clock has no ticker: pump the scheduler and tick its
        # time metrics here, as a service daemon does.
        deadline, last_tick = time.monotonic() + timeout, 0.0
        while not cond():
            if time.monotonic() > deadline:
                raise SystemExit(f"sched: timed out waiting for {what}; "
                                 f"status {sched.status_table()}")
            sched.pump()
            if time.monotonic() - last_tick >= 1.0:
                last_tick = time.monotonic()
                sched.update_time_metrics()
            observe()
            time.sleep(0.05)

    def submit(job):
        spec = JobSpec(name=job, pool="h100", model="llama_350m_af",
                       global_batch_size=8,
                       steps_per_epoch=SCHED_STEPS_PER_EPOCH,
                       config=JobConfig(min_num_chips=1, max_num_chips=1,
                                        epochs=SCHED_EPOCHS[job]))
        submitted[job] = time.monotonic()
        names[job] = admission.create_training_job(spec)

    def status(job):
        return store.get_job(names[job]).status.value

    thresholds = (tiresias.TIRESIAS_THRESHOLDS_SEC[0],
                  elastic_tiresias.LEASE_SECONDS)
    try:
        submit("a")
        epoch0 = os.path.join(workdir, names["a"], "ckpt",
                              f"step_{SCHED_STEPS_PER_EPOCH:010d}")
        wait(lambda: os.path.isdir(epoch0), "A's first checkpoint")
        # A has trained past its first checkpoint: lower the queue-0
        # threshold and the lease (one quantum) so that it is demoted now,
        # and B, arriving in queue 0, preempts it.
        tiresias.TIRESIAS_THRESHOLDS_SEC[0] = 1.0
        elastic_tiresias.LEASE_SECONDS = 1.0
        sched.update_time_metrics()
        if sched.ready_jobs[names["a"]].priority != 1:
            raise SystemExit("sched: A was not demoted")
        submit("b")
        wait(lambda: status("b") == "Running" and status("a") == "Waiting",
             "B to preempt A")
        # Back to the defaults, so that B is not demoted in turn and the
        # card does not go back to A before B completes.
        tiresias.TIRESIAS_THRESHOLDS_SEC[0], elastic_tiresias.LEASE_SECONDS \
            = thresholds
        wait(lambda: len(done) == 2, "both jobs to end")
    finally:
        tiresias.TIRESIAS_THRESHOLDS_SEC[0], elastic_tiresias.LEASE_SECONDS \
            = thresholds
        sched.stop()
        backend.close()
        if old_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_path

    a, b = names["a"], names["b"]
    logs = {job: log_text(job) for job in names}
    if [status(job) for job in names] != ["Completed", "Completed"] or \
            len(backend.stops) != 1:
        raise SystemExit(f"sched: status {sched.status_table()}, stops "
                         f"{backend.stops}; want both completed after one "
                         "preemption\n" + "\n".join(
                             f"--- {job}\n{logs[job][-3000:]}"
                             for job in names))
    spawns = [n for n, _ in backend.spawns]
    launches = [json.loads(m) for job in names for m in re.findall(
        r"^kernel launches (.*)$", logs[job], re.M)]
    resumed = [int(n) for n in re.findall(r"resumed at step (\d+) on 1 chips",
                                          logs["a"])]
    losses = {job: _epoch_losses(logs[job]) for job in names}
    rows = {job: [r["epoch"] for r in read_epoch_csv(os.path.join(
        backend.metrics_dir, f"{names[job]}.csv"))] for job in names}
    records = sched.profile_records(0)
    decide = statistics.median(r["decide_ms"] for r in records)
    t0 = submitted["a"]
    (_, rc, stop_t0, stop_t1), = backend.stops
    b_spawn = next(t for n, t in backend.spawns if n == b)
    a_respawn = [t for n, t in backend.spawns if n == a][-1]
    for job in names:
        # The first step of an incarnation also loads the kernels and
        # warms the allocator; the supervisor times it.
        warmups = re.findall(r"^warmup step \d+ took (\S+) s$", logs[job],
                             re.M)
        log(f"sched[{job}] status={status(job)} submit->first_step_s="
            f"{first_steps[job][0] - submitted[job]:.3f} submit->end_s="
            f"{done[job] - submitted[job]:.3f} warmup_step_s={warmups} "
            f"epoch_losses={losses[job]} csv_epochs={rows[job]}")
    restart_s = (first_steps["a"][1] - a_respawn
                 if len(first_steps["a"]) == 2 else math.nan)
    log(f"sched A SIGTERM->exit_s={stop_t1 - stop_t0:.3f} exit={rc} "
        f"resumed_at={resumed} restart->first_step_s={restart_s:.3f}")
    log(f"sched B wait: submit->spawn_s={b_spawn - submitted['b']:.3f} "
        f"A_exit->B_spawn_s={b_spawn - stop_t1:.3f}")
    log(f"sched makespan_s={max(done.values()) - t0:.3f} "
        f"passes={len(records)} median_decide_ms={decide:.3f} "
        f"spawns={spawns} launches={launches}")

    bad = []
    if spawns != [a, b, a] or backend.stops[0][0] != a or rc != 3:
        bad.append(f"spawns {spawns}, stops {backend.stops}: want A, B, A "
                   "and A's SIGTERM exit 3")
    if (len(resumed) != 1 or resumed[0] < SCHED_STEPS_PER_EPOCH
            or not math.isfinite(restart_s)):
        bad.append(f"A resumed at {resumed}, its restart trained "
                   f"{len(first_steps['a']) - 1} times")
    if not b_spawn >= stop_t1:
        bad.append("B started before A's first process exited")
    for job in names:
        if rows[job] != [str(e) for e in range(SCHED_EPOCHS[job])]:
            bad.append(f"{job}'s CSV epochs {rows[job]}")
    if len(launches) != 3 or any(min(c[k] for k in KERNELS) < 1
                                 for c in launches):
        bad.append(f"kernel launches {launches}")
    gap = abs(losses["a"].get(1, math.nan) - losses["b"].get(1, math.nan)) \
        / abs(losses["b"].get(1, math.nan))
    log(f"sched epoch-1 loss A={losses['a'].get(1)} B={losses['b'].get(1)} "
        f"rel_gap={gap:.3g} (bar 1e-3)")
    if not gap <= 1e-3:
        bad.append("A's and B's losses after the same steps differ")
    if bad:
        raise SystemExit("sched: " + "; ".join(bad) + "\n"
                         + "\n".join(f"--- {job}\n{logs[job][-3000:]}"
                                      for job in names))
    shutil.rmtree(workdir)
    return {k: sum(c[k] for c in launches) for k in KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vodascheduler_tpu_torch.ops import _build
    from vodascheduler_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    spills = {}
    for name in libs:
        text = (_build.build_dir() / f"{name}.log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"ptxas[{name}] {line.strip()}")
        spills.update(ptxas_spills(text))
    log("spills (bytes): " + " ".join(f"{n}@D={d}={b}" for (n, d), b
                                      in sorted(spills.items())))
    if spill_faults(spills):
        raise SystemExit("ptxas spill check failed: "
                         + "; ".join(spill_faults(spills)))

    # (B, H, Sq, Sk, D, causal, q_off)
    main_shape = (8, 16, 2048, 2048, 64, True, 0)
    cases = {"main": main_shape,
             "mixtral": (8, 10, 2048, 2048, 64, True, 0),
             "ragged": (2, 4, 1000, 1000, 64, True, 0),
             "ragged_noncausal": (2, 4, 1000, 1000, 64, False, 0),
             "d128": (2, 8, 1024, 1024, 128, True, 0),
             # head widths the kernels take zero-padded (to 64 and 128)
             "d16": (2, 4, 1024, 1024, 16, True, 0),
             "d96": (2, 4, 1024, 1024, 96, True, 0),
             "q_offset": (2, 4, 512, 2048, 64, True, 1536),
             "ragged_q_offset": (2, 4, 320, 1344, 64, True, 1024)}
    errs = check_kernels(fa, cases)
    rows = time_kernels(fa, main_shape, errs)
    for name in ("d16", "d96"):
        time_padded(fa, name, cases[name])
    torch.cuda.empty_cache()

    counts = run_slice(fa)
    gc.collect()
    torch.cuda.empty_cache()
    run_af_slice(fa)
    gc.collect()
    torch.cuda.empty_cache()
    run_job_cycle()
    gc.collect()
    torch.cuda.empty_cache()
    run_slice(fa, "mixtral_small", "moe")
    gc.collect()
    torch.cuda.empty_cache()
    run_af_slice(fa, "mixtral_small_af", "moe_af")
    gc.collect()
    torch.cuda.empty_cache()
    run_benches()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"sched launches (three supervisors, summed) {run_scheduler()}")

    kernels = [{"name": name, "route": "cuda", "source": r["source"],
                "replaces": r["replaces"], "launches": counts[name],
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["b"][0],
                "bound_by": r["b"][1], "library_ms": r["library_ms"]}
               for name, r in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
