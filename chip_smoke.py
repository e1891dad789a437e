"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card: name and power limit from nvidia-smi;
  2. build: the CUDA kernels of vodascheduler_tpu_torch/ops/csrc, by nvcc;
     fails if ptxas spills registers in the forward, dQ or dK/dV kernel at
     D=64 (the main path), in fp16's tensor-core forward, dQ or dK/dV at
     D=64 (phase 11's fp16 model), in fp32's tensor-core forward, dQ or
     dK/dV at D=64 (phase 11's fp32 model), in the wide forward, dQ or dK/dV at
     D=256 (phase 9's wide llama), in fp16's wide forward, dQ or dK/dV at
     D=256 (phase 11's fp16 model in heads of 256), in the forward, dQ or
     dK/dV above D=512 (flash_fwd_chunked_kernel, flash_dq_chunked_kernel,
     flash_dkv_chunked_kernel, bf16 and fp16) at D=640, or in fp32's
     TF32 forward above D=128 (`_f32_wide`, one instantiation for every
     width: CW=128, which D=256 runs), or in fp32's TF32 dQ and dK/dV
     (flash_dq_f32_kernel, flash_dkv_f32_kernel, one kernel each at every
     width) at CW=64 (D=64) and CW=128 (D=128 and every width above), and
     logs the spills at D=128, 384 and 512 and the chunked kernels' at 768
     and 1024;
  3. kernels: each kernel against its plain PyTorch version at llama_350m's
     attention shapes (B=8, H=16, S=2048, D=64, bf16, causal), at
     mixtral_small's (H=10), at a ragged S=1000, at D=128, at a query slice
     with q_offset and at a ragged query slice with q_offset, at head
     widths 16 and 96, which the kernels take zero-padded to 64 and 128 (as
     the attention operator sends them) against the plain versions at the
     true width, and at widths 256 (4 heads) and 512 (2 heads), B=8,
     S=2048, which the wide kernels take (flash_*_wide.cu), a ragged
     S=1000 at 256 (B=2, H=4), a query slice of 512 behind q_offset 1536 at
     256 (B=2, H=4) and width 384 (B=4, H=2, S=2048); then each
     timed with CUDA events beside its plain version, the PyTorch library call that
     computes the same function, and its bound on the card, and dQ then
     dK/dV timed as one backward beside the library's backward; the padded
     widths' forward and backward timed beside the library's, and the
     wide kernels at 256, 512 and 384 (the library's backward above 256 is
     autograd through scaled_dot_product_attention); then the fp32 and the
     fp16 kernels (fp32's forward, dQ and dK/dV on the tensor cores in
     three TF32 passes, csrc/flash_f32.cu, up to D=128 and above it
     streaming D, `_f32_wide`, fp32's dQ held against the plain version
     computed in fp64, F32_DQ_ACC; fp16's on the tensor cores up to D=128,
     flash_{fwd,dq,dkv}_f16, and above, flash_{fwd,dq,dkv}_f16_wide) against
     the same plain versions at the main shape, a
     ragged non-causal S, D=128, D=16 padded, a ragged query slice behind
     q_offset and D=256 (SIMT_LIMITS),
     each timed at the main shape beside its plain version, the library
     call (fp32's backward: autograd through scaled_dot_product_attention)
     and its bound at that dtype's peak; fp16's wide forward, dQ and dK/dV
     at the wide bf16 kernels' shapes (d256, d512, d384, a ragged S, the
     query slice behind q_offset, non-causal at 256), held to the same
     bars and timed at d256; fp16's CUDA-core
     forward, dQ and dK/dV held to the same bars at the main shape and
     timed in turns with the tensor-core kernels there and at d256; and
     fp32's CUDA-core forward, dQ and dK/dV (`_f32_simt`) held to fp32's
     bars at the main shape and timed in turns with the TF32 ones there, K2
     then K3 as one backward (`time[backward_f32 turns]`); fp32's TF32
     forward, dQ and dK/dV above D=128 (`_f32_wide`, which stream D) at
     F32_WIDE_CASES (d256 at B=8, H=4, S=2048; d384, d512, d640; a ragged
     S; non-causal with Sq ≠ Sk; a query slice behind q_offset; Sq=65;
     B·H=1), each launched twice and held bitwise, timed at d256 beside
     their plain versions, SDPA's fp32 forward, the library's fp32 backward
     and their bounds, and in turns there against the `_f32_simt` kernels
     they took the route from (held at d256 too), K2 then K3 as one
     backward against the `_f32_simt` pair (`time[backward_f32_wide
     turns]`); then K1 above D=512
     (flash_fwd_chunked_kernel, through flash_fwd_wide and
     flash_fwd_f16_wide) in bf16 (LIMITS) and fp16 (SIMT_LIMITS) at
     CHUNKED_CASES (D=640 at B=8, H=2, S=2048; 768, 896 and 1024; a ragged
     S; non-causal with Sq ≠ Sk; a query slice behind q_offset; Sq=65;
     B·H=1), each launched twice and held to give bitwise the same O and
     lse, timed at D=640 (fp16's in turns, one round, against
     flash_fwd_f16_simt, which it took the route from, held to the same
     bars there) beside the plain version, SDPA's forward and the bound,
     and once at D=1024 (B=8, H=1); the chunked kernel's launches count
     under flash_fwd_chunked and flash_fwd_f16_chunked, apart from the wide
     forward's D ≤ 512 ones; then K2 and K3 above D=512
     (flash_dq_chunked_kernel and flash_dkv_chunked_kernel, through the
     wide entries, counted as flash_dq_chunked and flash_dkv_chunked in
     bf16, flash_dq_f16_chunked and flash_dkv_f16_chunked in fp16) at the
     same CHUNKED_CASES, K1, K2 and K3 launched twice and held bitwise
     under LIMITS (bf16) and SIMT_LIMITS (fp16), and timed beside the plain
     versions, the library's backward and the bounds at D=640, B=2, H=2,
     S=1024 (two rounds) and at CHUNKED_CASES' d640 (one), fp16's in turns
     against the CUDA-core pair it took the route from (`_f16_simt`, held
     to the same bars at the first shape), K2 then K3 as one backward
     (`time[backward_chunked turns]`, `time[backward_f16_chunked turns]`);
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
     ElasticTiresias take two llama_350m_af jobs (B=8, 3 steps per epoch;
     A 4 epochs, B 2). A is submitted; at its first checkpoint the queue-0
     threshold and the lease are lowered so that A is demoted, and B is
     submitted and preempts it (SIGTERM, exit 3 with a checkpoint); B runs
     only after A's process has exited, and completes; A resumes (``resumed
     at step N on 1 chips``, N >= 3) and completes. One CSV row per epoch
     each, K1, K2 and K3 launched by every supervisor process, and A's
     second-epoch loss equal to B's (1e-3 relative: the same batches at the
     same steps). Printed: each job's submit -> first step and submit ->
     end, A's SIGTERM -> exit and restart -> first step, B's wait, the
     makespan, the passes and their median decide time;
  7. the service on the card: ``python -m vodascheduler_tpu_torch.service
     --chips 1 --algorithm ElasticFIFO`` (free ports, the journal on, the
     GPU monitor on through ``VODA_TPU_MONITOR=1``) takes two
     llama_350m_af jobs (B=8, 4 steps per epoch, 3 epochs) from ``python
     -m vodascheduler_tpu_torch.cli create -f``; B waits. At A's first
     checkpoint (its epoch-0 CSV row) the scheduler's /metrics reads A's
     memory (``voda_gpu_memory_bytes_in_use`` above its reading before A
     by 1 GiB, at most the card's total, which is torch's within 1%), and
     the card lists one compute process more than before the server, A's
     (where the card's processes carry pids of another namespace, as in
     a container that shows every process as pid 1, the server's pid
     proves nothing, so the count is held too). SIGINT stops
     the server (exit 0; A: SIGTERM, a checkpoint, exit 3), no supervisor
     is left, and ``cli fsck`` finds the journal clean. ``--resume`` on
     the same workdir brings the server back: A resumes (``resumed at
     step N on 1 chips``, N >= 4 and its last checkpoint) and completes,
     then B. ``cli get jobs`` lists both Completed, 3 CSV rows each,
     K1, K2 and K3 launched by every supervisor process, and A's
     last-epoch loss equal to B's (1e-3 relative). Printed: server up,
     SIGINT -> exit, --resume -> up, A's submit -> first step and restart
     -> first step, B's wait and submit -> completed, the makespan, the
     passes of both servers and their median decide time. Every process
     of the server's and the jobs' sessions is killed at the end;
  8. the repo's one-card example jobs through the server and the CLI, as
     they are: examples/jobs/llama-real-text.yaml, digits-real-data.yaml
     and examples/torch/custom-cnn.yaml, all Completed with a CSV row per
     epoch, the text job launching K1-K3 with its last-epoch loss below
     its first; each job's submit -> first step and submit -> completed;
  9. the families at full width, B=8, through TrainSession on the card:
     mnist_mlp, digits_mlp (the real digits), resnet50, bert_base,
     vit_l16 and nmt_base, each's bf16 step against an fp32 twin of the
     same weights (loss 2e-2 relative, each gradient's largest difference
     5e-2 of its largest value; resnet50's, averaged over seeds 0-7,
     0.135: TWIN_SEEDS), 3 steps on one batch (finite; digits_mlp's
     falling; no kernel launched: these families keep the plain attention,
     as in the reference), step ms, images or tokens per second and peak
     memory; llama_350m_text (the real corpus) through phase 4's checks
     (48/24/24 launches; its 5 steps on one batch finite, not held to
     fall: the reference's own do not, and phase 8 holds its job's loss
     to fall) and the twin check; a llama_350m-width bundle with
     4 heads of 256 through the wide kernels, phase 4's checks, launches
     48/24/24 of flash_*_wide;
  10. what a resize costs: the port's benchrunner (a fresh workdir, no
     cache) over ``meta`` and ``resize:llama_350m:b8``, whose worker runs
     the resize bench's three children on the card (prepare: 3 AdamW
     steps, the async save's initiate and drain, a synced save; restart:
     the cold start through `TrainSession.resume`'s halves to the first
     step; fast: one NCCL rank of a process group of one, the prepare
     child's 4 steps, then `TrainSession.resize(1)` (the in-place path:
     plan, mesh, groups, module with its kernels, optimizer, every state
     tensor moved) and the first step, timed together). Both rows
     measured; every restart segment present and >= 0, summing to the
     total within 1 ms a segment; checkpoint_bytes within 1% of the
     state's bytes; the cold row's seconds equal to resize_cost_seconds;
     the fast row measured 1 -> 1, its seconds fast_resize_ms's, no
     fast_error, its first step launching 48/24/24 and its loss within
     1e-5 relative of the prepare child's same step, the peak of device
     memory across the resize above the memory before it and at most the
     card's; the children's telemetry peaking above 1 GiB and at most the
     card's memory; the prepare and restart children's launches of K1-K3
     (48/24/24 a step) and the kernels found built; the restart's first
     and second step losses within 1e-3 relative of the same steps in the
     prepare child (the second reads the restored optimizer state);
     `derive_costs` on the row finite for every family, both costs
     "measured on llama_350m". Printed: the segments, the saves, the fast
     row beside the cold one and the derived family costs, with the card's
     name and power limit;
  11. models that compute in fp32 and in fp16: a llama_350m-width bundle
     of 4 layers in each, through TrainSession on the card, its step
     through the fp32 or fp16 kernels against the plain attention (fp32:
     loss 1e-4, hidden state and gradients 1e-3; fp16: phase 4's bars,
     the loss scaled by 1024 for the comparison),
     5 steps (finite, falling), one counted step launching that dtype's
     K1 8, K2 4 and K3 4 times and no other kernel (fp32: flash_fwd_f32,
     flash_dq_f32, flash_dkv_f32, all in TF32; fp16: flash_fwd_f16, flash_dq_f16,
     flash_dkv_f16); then the same fp16 model in 4 heads of 256, through
     the wgmma flash_fwd_f16_wide, flash_dq_f16_wide and
     flash_dkv_f16_wide (8/4/4), and the fp32 model in 4 heads of 256,
     through flash_fwd_f32_wide, flash_dq_f32_wide and flash_dkv_f32_wide
     (8/4/4), and no `_f16_simt` or `_f32_simt` kernel;
  12. one job on a process group: llama_350m (B=8, S=2048, AdamW) through
     the supervisor's rendezvous at world size 1 (the coordinator's
     environment for one process: the agent spawns one rank, NCCL, a
     DeviceMesh of one, every parameter a DTensor, K1-K3 on the rank's
     local tensors, 48/24/24 a step), every step's loss (printed inside the
     rank by a user script) within 1e-3 relative of the plain one-card
     TrainSession's same step, finite and falling over its first 6 steps;
     in its first epoch a resize to 1 acked in place and a resize to 2
     nacked ``restart_required`` (the rank holds one card; the user script
     holds the rank's first step until the first command is written);
     SIGTERM after its epoch of 6 steps: exit 3 with a sharded checkpoint;
     the one-card path (no coordinator) resumes it (`resumed at step N on 1
     chips`) and is stopped likewise, and the rank resumes that plain
     checkpoint and trains to step 17; the rank's step time (CSV rows)
     beside the one-card path's and the plain session's, the saves and the
     restores, with the card's name and power limit. Then mixtral_small
     (B=8, S=2048, AdamW, dim 640, 12 layers, 8 experts) the same way for
     one epoch of 4 steps: the rank runs the expert-parallel form of the
     gather dispatch (the routing's all-gather over the data axes and the
     experts' sums over ep and tp, NCCL groups of one), 24/12/12 a step,
     each step's loss within 1e-3 of the plain session's and falling, a
     sharded save at the end, which the one-card path resumes in this
     process, its next step within 1e-3 of the plain session's; the rank's
     step ms beside the one-card path's, the save and restore s;
  13. one JSON line of the kernels, then the device line last.

A line "phase N took T s" follows each phase.

Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# The card's peak for each input dtype of the attention kernels: fp16 as
# bf16 on the tensor cores; fp32 at TF32's 495 TFLOP/s over three passes,
# the card's fp32-accurate rate (each fp32 product as a_lo·b_hi + a_hi·b_lo
# + a_hi·b_hi of TF32 halves), on which the library's own fp32 attention and
# the port's fp32 K1, K2 and K3 run (NVIDIA data sheet, SXM).
PEAK_FLOPS = {torch.bfloat16: PEAK_BF16_FLOPS, torch.float16: 989e12,
              torch.float32: 495e12 / 3}
TPU_SRC = "vodascheduler_tpu/ops/flash_attention.py"
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a) -> None:
    print(*a, flush=True)


# Kernels that must not spill registers at the main path's head_dim (the
# bf16 kernels, fp16's on the tensor cores and fp32's in TF32).
SPILL_FREE = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_f16",
              "flash_dq_f16", "flash_dkv_f16", "flash_fwd_f32",
              "flash_dq_f32", "flash_dkv_f32")
MAIN_HEAD_DIM = 64
# The wide kernels redesigned on wgmma, held to no spill at the width of
# phase 9's 256-wide llama and of phase 11's fp16 model in heads of 256
# (their spills at 384 and 512 are only logged).
WIDE_SPILL_FREE = ("flash_fwd_wide", "flash_dq_wide", "flash_dkv_wide",
                   "flash_fwd_f16_wide", "flash_dq_f16_wide",
                   "flash_dkv_f16_wide")
WIDE_HEAD_DIM = 256
MAIN_SPILL_GATES = tuple((n, MAIN_HEAD_DIM) for n in SPILL_FREE)
# The kernels above D=512 that stream D (flash_fwd_chunked_kernel,
# flash_dq_chunked_kernel and flash_dkv_chunked_kernel) are templated on
# the width of their chunk of the output, CW, not on D: D=640 runs CW=128,
# held to no spill in both dtypes; CW=256, which D=768 and 1024 run, is
# only logged.
CHUNKED_SPILL_GATES = (("flash_fwd_chunked", 128),
                       ("flash_fwd_chunked_f16", 128),
                       ("flash_dq_chunked", 128),
                       ("flash_dkv_chunked", 128),
                       ("flash_dq_chunked_f16", 128),
                       ("flash_dkv_chunked_f16", 128))
# fp32's TF32 forward above D=128 takes D at run time and is templated on
# its chunk of O alone, CW=128: the one instantiation runs every width,
# D=256 (phase 11's fp32 model in heads of 256) among them, and is held to
# no spill. So are fp32's TF32 dQ and dK/dV (flash_dq_f32_kernel,
# flash_dkv_f32_kernel, one kernel each at every width) at CW=128, which
# D=128 and every width above run; D=64 runs CW=64 (MAIN_SPILL_GATES).
F32_WIDE_SPILL_GATES = (("flash_fwd_f32_wide", 128),
                        ("flash_dq_f32", 128),
                        ("flash_dkv_f32", 128))
SPILL_GATES = (MAIN_SPILL_GATES
               + tuple((n, WIDE_HEAD_DIM) for n in WIDE_SPILL_FREE)
               + CHUNKED_SPILL_GATES + F32_WIDE_SPILL_GATES)
# The gated kernels templated on a chunk of the output, not on D.
CW_TEMPLATED = {n for n, _ in CHUNKED_SPILL_GATES + F32_WIDE_SPILL_GATES}


def ptxas_spills(text: str) -> dict:
    """{(kernel, head_dim): bytes of spill stores + loads} from the log of
    `nvcc -Xptxas -v` (a "Function properties for <mangled name>" line,
    then its "... bytes spill stores, ... bytes spill loads" line). A kernel
    templated on fp16 (``__half`` after its width) is named as the wrappers
    name it, ``_f16`` before any ``_wide``."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            k = re.search(r"(flash_\w+?)_kernelILi(\d+)E(6__half)?", fn)
            if k:
                name = k.group(1)
                if k.group(3):
                    base = name.removesuffix("_wide")
                    name = base + "_f16" + name[len(base):]
                out[(name, int(k.group(2)))] = (int(m.group(1))
                                                + int(m.group(2)))
            fn = None
    return out


def spill_faults(spills: dict, gates=MAIN_SPILL_GATES) -> list:
    """What the spill check refuses: a spill, or no ptxas line at all, for
    a (kernel, head_dim) of `gates` (phase 2 holds SPILL_GATES)."""
    faults = []
    for name, dim in gates:
        got = spills.get((name, dim))
        what = f"{name} {'CW' if name in CW_TEMPLATED else 'D'}={dim}"
        if got is None:
            faults.append(f"{what}: no ptxas spill line")
        elif got:
            faults.append(f"{what}: {got} bytes spilled")
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
          causal, q_off, dtype=torch.bfloat16):
    """(ms, 'operations' | 'bytes'): the least time on the card, for
    tensors of `dtype` (its element size, its peak rate)."""
    flops = n_products * 2 * B * H * attn_pairs(Sq, Sk, causal, q_off) * D
    nbytes = (n_tensors * B * max(Sq, Sk) * H * D * dtype.itemsize
              + n_stats * B * H * Sq * 4)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
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
# The same bars for the fp32 and fp16 kernels. fp32: the kernels and the
# plain versions both compute in fp32 and differ by the order of their
# sums; dQ's first rows are 0 by cancellation (δ against dO·V), held to
# 1e-3 of the largest row (`row_err`), where the plain version's own fp32
# rounding reads up to 2.6e-3 against its fp64 value at D=512 (H100), so
# fp32's dQ is held against the plain version computed in fp64
# (F32_DQ_ACC). fp16: O, dQ, dK, dV are rounded to fp16 and the
# kernels round P to fp16 before its products, as the TPU kernels do and
# the plain versions do not: half a bf16 bar. lse and δ are fp32 sums of
# the same terms in both.
F32_DQ_ACC = torch.float64
SIMT_LIMITS = {
    torch.float32: {"o_row": 1e-4, "lse": 1e-4, "delta": 1e-4,
                    "dq_row": 1e-3, "dk_row": 1e-4, "dv_row": 1e-4},
    torch.float16: {"o_row": 5e-3, "lse": 1e-3, "delta": 1e-3,
                    "dq_row": 5e-3, "dk_row": 5e-3, "dv_row": 5e-3}}


def kernel_errors(fa, name, shape, dtype=torch.bfloat16, limits=LIMITS,
                  twice=False):
    """Errors of each kernel against its plain version at one shape, on
    tensors of `dtype`, logged with the bars of `limits` they break:
    (errors, ["name=err>bar", ...]). A head width
    the kernels are not built for goes in as the attention operator sends
    it: zero-padded along D to the kernels' width, with D's own scale, and
    cut back to D; the plain versions run at D itself. With `twice`, K1,
    K2 and K3 are launched a second time on the same inputs, and a result
    that differs from the first by a bit is a broken bar."""
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(1)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
    do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
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
    if dtype == torch.float32:
        # fp32's dQ against the plain version computed in fp64 (F32_DQ_ACC)
        dq_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off,
                                       acc=F32_DQ_ACC)[0]
    dk, dv = fa.flash_dkv(qp, kp, vp, dop, lse, delta_ref, causal, q_off,
                          scale=scale)
    dk, dv = dk[..., :D], dv[..., :D]
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta_ref,
                                            causal, q_off)
    differ = []
    if twice:
        o2, lse2 = fa.flash_fwd(qp, kp, vp, causal, q_off, scale=scale)
        dq2, delta2 = fa.flash_dq(qp, kp, vp, fa.pad_head(o, width), dop,
                                  lse, causal, q_off, scale=scale)
        dk2, dv2 = fa.flash_dkv(qp, kp, vp, dop, lse, delta_ref, causal,
                                q_off, scale=scale)
        differ = [n for n, first, second in (
                      ("o", o, o2[..., :D]), ("lse", lse, lse2),
                      ("dq", dq, dq2[..., :D]), ("delta", delta, delta2),
                      ("dk", dk, dk2[..., :D]), ("dv", dv, dv2[..., :D]))
                  if not torch.equal(first, second)]
        del o2, lse2, dq2, delta2, dk2, dv2
    torch.cuda.synchronize()
    errs = {"o_row": row_err(o, o_ref), "o": abs_err(o, o_ref),
            "lse": abs_err(lse, lse_ref), "delta": abs_err(delta, delta_ref),
            "dq_row": row_err(dq, dq_ref), "dk_row": row_err(dk, dk_ref),
            "dv_row": row_err(dv, dv_ref),
            "dq": rel_err(dq, dq_ref), "dk": rel_err(dk, dk_ref),
            "dv": rel_err(dv, dv_ref), "dq_abs": abs_err(dq, dq_ref),
            "dk_abs": abs_err(dk, dk_ref), "dv_abs": abs_err(dv, dv_ref)}
    bad = [f"{n}={errs[n]:.3g}>{lim}" for n, lim in limits.items()
           if not errs[n] <= lim]
    bad += [f"two launches differ in {n}" for n in differ]
    log(f"kernels[{name}] {str(dtype)[6:]} B={B} H={H} Sq={Sq} Sk={Sk} D={D} "
        f"causal={causal} q_off={q_off} "
        + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + (" FAIL " + ",".join(bad) if bad else " ok")
        + (", K1, K2 and K3 bitwise equal twice" if twice and not bad
           else ""))
    del q, k, v, do, qp, kp, vp, dop, o, lse, o_ref, lse_ref, dq, dq_ref
    del dk, dv
    torch.cuda.empty_cache()
    return errs, bad


def check_kernels(fa, cases, dtype=torch.bfloat16, limits=LIMITS,
                  twice=False):
    """Each kernel against its plain version at every case (K1, K2 and K3
    launched twice and held bitwise, with `twice`); returns the errors at
    the first case (the main shape), with each case's under its name, and
    fails after reporting every case."""
    failures, out = [], {}
    for name, shape in cases.items():
        errs, bad = kernel_errors(fa, name, shape, dtype, limits, twice)
        failures += [f"{name}: {b}" for b in bad]
        out[name] = errs
    if failures:
        raise SystemExit("kernel check failed: " + "; ".join(failures))
    return {**out[next(iter(cases))], **out}


def library_times(q, k, v, do, causal):
    """PyTorch's own attention on the same inputs, timed as a yardstick
    only (the port never calls it): (fwd_ms, bwd_ms). The backward is the
    flash backend's up to D=256; above that, where PyTorch's flash backend
    stops, one autograd backward through scaled_dot_product_attention
    (the backend it picks for that width), as for fp32, which the flash
    backend does not take."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=causal))
    if q.shape[-1] > 256 or q.dtype == torch.float32:
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        dot = do.transpose(1, 2)
        bwd = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                                  retain_graph=True))
        return fwd, bwd
    qc, kc, vc, doc = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    out, lse, cq, ck, mq, mk, seed, off = \
        torch.ops.aten._scaled_dot_product_flash_attention(
            qc, kc, vc, 0.0, causal)[:8]
    bwd = cuda_ms(lambda: torch.ops.aten
                  ._scaled_dot_product_flash_attention_backward(
                      doc, qc, kc, vc, out, lse, cq, ck, mq, mk, 0.0, causal,
                      seed, off))
    return fwd, bwd


def time_kernels(fa, shape, errs, suffix="", dtype=torch.bfloat16):
    """Each kernel that the wrappers take for these tensors (`suffix`, which
    labels the backward's line: "" or "_wide" on bf16, "_f32" or "_f16" on
    `dtype`) timed beside its plain version, the library's call and its
    bound; logged, and returned as rows of the kernels' JSON line, under
    the names of the kernels that ran."""
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(2)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
    do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
    src = "vodascheduler_tpu_torch/ops/csrc/{}.cu"
    kern = {n: fa._kernel(n, D, dtype)
            for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    _, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    rows = {
        kern["flash_fwd"]: dict(
            ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, q_off)),
            plain_ms=cuda_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal, q_off), reps=10),
            b=bound(2, 4, 1, *shape, dtype), err=max(errs["o"], errs["lse"]),
            replaces=f"{TPU_SRC}:114",
            source=src.format(fa.source(kern["flash_fwd"]))),
        kern["flash_dq"]: dict(
            ms=cuda_ms(lambda: fa.flash_dq(q, k, v, o, do, lse, causal,
                                           q_off)),
            plain_ms=cuda_ms(lambda: fa.flash_dq_reference(
                q, k, v, o, do, lse, causal, q_off), reps=10),
            b=bound(3, 6, 2, *shape, dtype), err=errs["dq_abs"],
            replaces=f"{TPU_SRC}:215",
            source=src.format(fa.source(kern["flash_dq"]))),
        kern["flash_dkv"]: dict(
            ms=cuda_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal,
                                            q_off)),
            plain_ms=cuda_ms(lambda: fa.flash_dkv_reference(
                q, k, v, do, lse, delta, causal, q_off), reps=10),
            b=bound(4, 6, 2, *shape, dtype),
            err=max(errs["dk_abs"], errs["dv_abs"]),
            replaces=f"{TPU_SRC}:260",
            source=src.format(fa.source(kern["flash_dkv"]))),
    }
    lib_fwd, lib_bwd = library_times(q, k, v, do, causal)
    rows[kern["flash_fwd"]]["library_ms"] = lib_fwd
    # The library's backward computes dq, dk and dv in one call; it stands
    # beside both backward kernels.
    rows[kern["flash_dq"]]["library_ms"] = lib_bwd
    rows[kern["flash_dkv"]]["library_ms"] = lib_bwd
    for name, r in rows.items():
        log(f"time[{name}] D={D} H={H} kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} bound_ms={r['b'][0]:.4f} "
            f"({r['b'][1]}) roofline_share={r['b'][0] / r['ms']:.3f}")
    bwd_ms = cuda_ms(backward_call(fa, q, k, v, o, do, lse, causal, q_off))
    b = bound(7, 8, 1, *shape, dtype)
    log(f"time[backward{suffix}] D={D} kernel_ms={bwd_ms:.4f} (dq then dkv) "
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


# fp16's kernels on the CUDA cores (`_f16_simt`), which no route takes since
# the kernels that stream D replaced them above D=512: they take any width,
# so at D=64 and D=256 they stand beside the tensor-core kernels that
# replaced them there.
CUDA_CORE_F16 = {"flash_fwd_f16": "flash_fwd_f16_simt",
                 "flash_dq_f16": "flash_dq_f16_simt",
                 "flash_dkv_f16": "flash_dkv_f16_simt",
                 "flash_fwd_f16_wide": "flash_fwd_f16_simt",
                 "flash_dq_f16_wide": "flash_dq_f16_simt",
                 "flash_dkv_f16_wide": "flash_dkv_f16_simt"}
# fp32's forward, dQ and dK/dV on the CUDA cores (`_f32_simt`): no route
# takes them since the TF32 kernels replaced them at every width, and they
# take any width, so at D=64 they stand beside the TF32 kernels that
# replaced them there.
CUDA_CORE_F32 = {"flash_fwd_f32": "flash_fwd_f32_simt",
                 "flash_dq_f32": "flash_dq_f32_simt",
                 "flash_dkv_f32": "flash_dkv_f32_simt"}
# Above D=128 the same CUDA-core kernels stand beside the TF32 wide ones
# that took their route (flash_f32.cu: `_f32_wide`), to be timed in turns.
CUDA_CORE_F32_WIDE = {"flash_fwd_f32_wide": "flash_fwd_f32_simt",
                      "flash_dq_f32_wide": "flash_dq_f32_simt",
                      "flash_dkv_f32_wide": "flash_dkv_f32_simt"}
# (B, H, Sq, Sk, D, causal, q_off) of fp32 above D=128: the timed shape
# first (the wide bf16 rows' d256), the widths of three, four and five
# 128-column chunks, a ragged S, non-causal with Sq ≠ Sk, a query slice
# behind q_offset, Sq = 65, B·H = 1
F32_WIDE_CASES = {
    "d256": (8, 4, 2048, 2048, 256, True, 0),
    "d384": (2, 2, 1024, 1024, 384, True, 0),
    "d512": (2, 2, 1024, 1024, 512, True, 0),
    "d640": (2, 1, 1024, 1024, 640, True, 0),
    "d256_ragged": (2, 4, 1000, 1000, 256, True, 0),
    "d384_noncausal": (2, 2, 700, 1000, 384, False, 0),
    "d256_q_offset": (2, 4, 512, 2048, 256, True, 1536),
    "d512_sq65": (2, 2, 65, 65, 512, True, 0),
    "d256_bh1": (1, 1, 1000, 1000, 256, True, 0)}


def backward_turns(tag, D, turns, table, library_ms, card) -> None:
    """Logs K2 then K3 as one backward, each pair the sum of its kernels'
    medians in turns (`time_turns`): the tensor-core pair of `table` (its
    dQ and dK/dV keys) against the CUDA-core pair it maps them to, beside
    the library's backward."""
    new = [n for n in table if "_dq_" in n or "_dkv_" in n]
    old = [table[n] for n in new]
    ms_new, ms_old = (sum(turns[n] for n in pair) for pair in (new, old))
    log(f"time[{tag} turns] D={D} {new[0]} then {new[1]} ms={ms_new:.4f} "
        f"({new[0]} {turns[new[0]]:.4f}; sums of the medians in turns) "
        f"{old[0]} then {old[1]} ms={ms_old:.4f} "
        f"cuda_cores_over_tensor_cores={ms_old / ms_new:.3f} "
        f"library_ms={library_ms:.4f} "
        f"kernels_over_library={ms_new / library_ms:.3f} card={card}")


@contextlib.contextmanager
def routed(fa, table):
    """The wrappers of `fa` launching, for each kernel of `table`, the
    kernel it maps to."""
    kernel = fa._kernel
    fa._kernel = lambda *a: table.get(kernel(*a), kernel(*a))
    try:
        yield
    finally:
        fa._kernel = kernel


def time_turns(fa, shape, dtype=torch.float16, table=CUDA_CORE_F16,
               rounds=2) -> dict:
    """K1, K2 and K3 of `dtype` at `shape`, on the tensor cores and on the
    CUDA cores (`table`: CUDA_CORE_F16 or CUDA_CORE_F32; an empty table
    times the tensor-core kernels alone), timed in turns (tensor, CUDA,
    CUDA, tensor) `rounds` times on the same inputs by CUDA events; logged,
    and returned as {kernel: median ms}."""
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(2)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .to(dtype) for S in (Sq, Sk, Sk, Sq))
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    _, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, causal, q_off),
             "flash_dq": lambda: fa.flash_dq(q, k, v, o, do, lse, causal,
                                             q_off),
             "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                               causal, q_off)}
    times = {}
    for _ in range(rounds):
        for turn in ({}, table, table, {}):
            with routed(fa, turn):
                for name, call in calls.items():
                    times.setdefault(fa._kernel(name, D, dtype),
                                     []).append(cuda_ms(call))
    med = {n: statistics.median(t) for n, t in times.items()}
    for new, old in table.items():
        if new not in med:
            continue
        log(f"time[{fa.SIMT_SUFFIX[dtype]} turns] D={D} {new} "
            f"ms={med[new]:.4f} "
            f"{[round(x, 4) for x in times[new]]} {old} ms={med[old]:.4f} "
            f"{[round(x, 4) for x in times[old]]} "
            f"cuda_cores_over_tensor_cores={med[old] / med[new]:.3f}")
    return med


# K1 above D=512: flash_fwd_chunked_kernel (csrc/flash_fwd_wide.cu), which
# the wide forward's entries launch there in bf16 and fp16, and the kernel
# fp16's took that route from, reached only to be timed against it in turns
# (bf16's, on wmma, is gone).
OLD_FWD_ABOVE_512 = {"flash_fwd_f16_wide": "flash_fwd_f16_simt"}
# (B, H, Sq, Sk, D, causal, q_off): the timed shape first (B·H·D near
# d256's and d512's), every chunk width to 1024, a ragged S, non-causal
# with Sq ≠ Sk, a query slice behind q_offset, Sq = 65, B·H = 1
CHUNKED_CASES = {
    "d640": (8, 2, 2048, 2048, 640, True, 0),
    "d768": (2, 2, 1024, 1024, 768, True, 0),
    "d896": (2, 1, 1024, 1024, 896, True, 0),
    "d1024": (2, 1, 1024, 1024, 1024, True, 0),
    "d640_ragged": (2, 2, 1000, 1000, 640, True, 0),
    "d768_noncausal": (2, 2, 700, 1000, 768, False, 0),
    "d640_q_offset": (2, 2, 512, 2048, 640, True, 1536),
    "d896_sq65": (2, 2, 65, 65, 896, True, 0),
    "d1024_bh1": (1, 1, 1000, 1000, 1024, True, 0)}
D1024_SHAPE = (8, 1, 2048, 2048, 1024, True, 0)


def forward_errors(fa, name, shape, dtype, limits):
    """K1 alone against its plain version at one shape, launched twice on
    the same inputs: (errors, bars of `limits` broken), a second launch
    that differs from the first by a bit among them. Logged, with the
    kernel the wrapper launched."""
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(3)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
               for S in (Sq, Sk, Sk))
    kernel = fa.counted(fa._kernel("flash_fwd", D, dtype), D)
    before = fa.launches[kernel]
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    o2, lse2 = fa.flash_fwd(q, k, v, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    torch.cuda.synchronize()
    errs = {"o_row": row_err(o, o_ref), "o": abs_err(o, o_ref),
            "lse": abs_err(lse, lse_ref)}
    bad = [f"{n}={errs[n]:.3g}>{limits[n]}" for n in ("o_row", "lse")
           if not errs[n] <= limits[n]]
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        bad.append("two launches differ")
    if fa.launches[kernel] - before != 2:
        bad.append(f"{kernel} not launched")
    log(f"forward[{name}] {kernel} {str(dtype)[6:]} B={B} H={H} Sq={Sq} "
        f"Sk={Sk} D={D} causal={causal} q_off={q_off} "
        + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + (" FAIL " + ",".join(bad) if bad else " ok, bitwise equal twice"))
    del q, k, v, o, o2, lse, lse2, o_ref, lse_ref
    torch.cuda.empty_cache()
    return errs, bad


def check_chunked(fa, dtype, limits) -> dict:
    """K1 above D=512 at every CHUNKED_CASES in `dtype`, by
    forward_errors; then, where `dtype` has one (OLD_FWD_ABOVE_512), the
    kernel it took the route from at the first case. Fails after reporting
    every case; returns the errors by case, the old kernel's under its
    name."""
    failures, out = [], {}
    for name, shape in CHUNKED_CASES.items():
        route = fa._kernel("flash_fwd", shape[4], dtype)
        if fa.counted(route, shape[4]) != fa.CHUNKED_COUNTS.get(route):
            failures.append(f"{name}: not the chunked kernel's route")
        out[name], bad = forward_errors(fa, name, shape, dtype, limits)
        failures += [f"{name}: {b}" for b in bad]
    if fa._kernel("flash_fwd", 640, dtype) in OLD_FWD_ABOVE_512:
        with routed(fa, OLD_FWD_ABOVE_512):
            old = fa._kernel("flash_fwd", 640, dtype)
            out[old], bad = forward_errors(fa, "d640", CHUNKED_CASES["d640"],
                                           dtype, limits)
        failures += [f"{old} d640: {b}" for b in bad]
    if failures:
        raise SystemExit("K1 above D=512 failed: " + "; ".join(failures))
    return out


def time_forward(fa, shape, dtype, old=None, rounds=2) -> dict:
    """K1 at `shape` in `dtype`, the kernel the wrapper takes, and `old`
    where given, timed in turns (new, old, old, new) `rounds` times on the
    same inputs by CUDA events, beside the plain version, SDPA's forward
    and the bound; logged, and returned as rows of the kernels' JSON line
    by kernel (medians of the turns)."""
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(2)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
               for S in (Sq, Sk, Sk))
    new = fa._kernel("flash_fwd", D, dtype)
    call = lambda: fa.flash_fwd(q, k, v, causal, q_off)
    times = {new: []}
    turns = ({}, {new: old}, {new: old}, {}) if old else ({},)
    for _ in range(rounds if old else 1):
        for turn in turns:
            with routed(fa, turn):
                times.setdefault(fa._kernel("flash_fwd", D, dtype),
                                 []).append(cuda_ms(call))
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal, q_off), warmup=1, reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    b = bound(2, 4, 1, *shape, dtype)
    rows = {}
    for name, t in times.items():
        ms = statistics.median(t)
        rows[name] = dict(
            ms=ms, plain_ms=plain_ms, b=b, library_ms=lib_ms,
            replaces=f"{TPU_SRC}:114",
            source=f"vodascheduler_tpu_torch/ops/csrc/{fa.source(name)}.cu")
        log(f"time[forward {str(dtype)[6:]}] D={D} B={B} H={H} S={Sq} "
            f"{fa.counted(name, D)} "
            f"ms={ms:.4f} {[round(x, 4) for x in t]} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b[0]:.4f} ({b[1]}) "
            f"roofline_share={b[0] / ms:.3f} library_over_kernel="
            f"{lib_ms / ms:.3f}")
    if old:
        log(f"time[forward turns] D={D} {str(dtype)[6:]} {old} over {new}: "
            f"{rows[old]['ms'] / rows[new]['ms']:.3f}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def run_chunked(fa) -> dict:
    """Phase 3's K1 above D=512 in bf16 (LIMITS) and fp16
    (SIMT_LIMITS[float16]): checked at every CHUNKED_CASES, timed at
    CHUNKED_CASES["d640"] (fp16's in turns against the kernel it took the
    route from), and once at D1024_SHAPE. Returns the rows of the kernels'
    JSON line, at d640: the new kernel's under the name it counts under
    (fa.CHUNKED_COUNTS: the wide forward's d256 rows keep the route's name),
    the old kernel's under its own."""
    rows = {}
    for dtype, limits in ((torch.bfloat16, LIMITS),
                          (torch.float16, SIMT_LIMITS[torch.float16])):
        errs = check_chunked(fa, dtype, limits)
        new = fa._kernel("flash_fwd", 640, dtype)
        old = OLD_FWD_ABOVE_512.get(new)
        timed = time_forward(fa, CHUNKED_CASES["d640"], dtype, old, rounds=1)
        timed[new]["err"] = max(errs["d640"]["o"], errs["d640"]["lse"])
        rows[fa.CHUNKED_COUNTS[new]] = timed[new]
        if old:
            timed[old]["err"] = max(errs[old]["o"], errs[old]["lse"])
            rows[old] = timed[old]
        time_forward(fa, D1024_SHAPE, dtype)
    return rows


# K2 and K3 above D=512: flash_dq_chunked_kernel and
# flash_dkv_chunked_kernel (csrc/flash_{dq,dkv}_wide.cu), which the wide
# entries launch there in bf16 and fp16, and the CUDA-core kernels fp16's
# took that route from, reached only to be timed against them in turns
# (bf16's, on wmma, are gone).
OLD_BWD_ABOVE_512 = {"flash_dq_f16_wide": "flash_dq_f16_simt",
                     "flash_dkv_f16_wide": "flash_dkv_f16_simt"}
# The shape of the row of record of the pairs they replaced (D=640, B=2,
# H=2, S=1024)
BWD_RECORD_SHAPE = (2, 2, 1024, 1024, 640, True, 0)
# The counts of K2 and K3 above D=512, and their bars, by dtype
BWD_CHUNKED_COUNTS = {
    torch.bfloat16: ("flash_dq_chunked", "flash_dkv_chunked"),
    torch.float16: ("flash_dq_f16_chunked", "flash_dkv_f16_chunked")}
BWD_CHUNKED_LIMITS = {torch.bfloat16: LIMITS,
                      torch.float16: SIMT_LIMITS[torch.float16]}


def time_backward_turns(fa, shape, rounds: int, dtype) -> dict:
    """K2 and K3 of `dtype` at `shape`: the kernels the wrappers take and,
    in fp16, the CUDA-core ones (OLD_BWD_ABOVE_512), timed in turns
    `rounds` times (time_turns), beside the plain versions, the library's
    backward and the bounds; logged, K2 then K3 as one backward. Returns
    rows of the kernels' JSON line by the names the kernels count under."""
    B, H, Sq, Sk, D, causal, q_off = shape
    routes = [fa._kernel(n, D, dtype) for n in ("flash_dq", "flash_dkv")]
    table = {r: OLD_BWD_ABOVE_512[r] for r in routes
             if r in OLD_BWD_ABOVE_512}
    med = time_turns(fa, shape, dtype, table, rounds)
    g = torch.Generator("cuda").manual_seed(2)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .to(dtype) for S in (Sq, Sk, Sk, Sq))
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    _, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    plain = {"flash_dq": cuda_ms(lambda: fa.flash_dq_reference(
                 q, k, v, o, do, lse, causal, q_off), warmup=1, reps=5),
             "flash_dkv": cuda_ms(lambda: fa.flash_dkv_reference(
                 q, k, v, do, lse, delta, causal, q_off), warmup=1, reps=5)}
    _, lib_bwd = library_times(q, k, v, do, causal)
    tag = "" if dtype == torch.bfloat16 else f"_{fa.SIMT_SUFFIX[dtype]}"
    rows, pair = {}, {}
    for name, n_products, line in (("flash_dq", 3, 215),
                                   ("flash_dkv", 4, 260)):
        new = fa._kernel(name, D, dtype)
        old = table.get(new)
        b = bound(n_products, 6, 2, *shape, dtype)
        pair[name] = (med[new], med.get(old))
        for kernel, count in ((new, fa.counted(new, D)), (old, old)):
            if kernel is None:
                continue
            rows[count] = dict(
                ms=med[kernel], plain_ms=plain[name], b=b,
                library_ms=lib_bwd, replaces=f"{TPU_SRC}:{line}",
                source=("vodascheduler_tpu_torch/ops/csrc/"
                        f"{fa.source(kernel)}.cu"))
        log(f"time[{fa.SIMT_SUFFIX.get(dtype, 'bf16')} chunked] D={D} B={B} "
            f"H={H} S={Sq} "
            f"{fa.counted(new, D)} ms={med[new]:.4f} "
            f"roofline_share={b[0] / med[new]:.3f} bound_ms={b[0]:.4f} "
            f"({b[1]}) plain_ms={plain[name]:.4f} library_ms={lib_bwd:.4f}"
            + (f" {old} ms={med[old]:.4f} cuda_cores_over_tensor_cores="
               f"{med[old] / med[new]:.3f}" if old else ""))
    new_ms = sum(t[0] for t in pair.values())
    b = bound(7, 8, 1, *shape, dtype)
    dq, dkv = (fa.counted(fa._kernel(n, D, dtype), D)
               for n in ("flash_dq", "flash_dkv"))
    line = (f"time[backward{tag}_chunked turns] D={D} B={B} H={H} S={Sq} "
            f"{dq} then {dkv} ms={new_ms:.4f} (sum of the medians in turns) "
            f"roofline_share={b[0] / new_ms:.3f} bound_ms={b[0]:.4f} "
            f"({b[1]}) library_ms={lib_bwd:.4f} "
            f"library_over_kernels={lib_bwd / new_ms:.3f}")
    if table:
        old_ms = sum(t[1] for t in pair.values())
        line += (f" _f16_simt pair ms={old_ms:.4f} "
                 f"cuda_cores_over_tensor_cores={old_ms / new_ms:.3f}")
    log(line)
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return rows


def run_chunked_backward(fa) -> dict:
    """Phase 3's K2 and K3 above D=512 in bf16 (LIMITS) and fp16
    (SIMT_LIMITS[float16]): each kernel against its plain version at every
    CHUNKED_CASES, K1, K2 and K3 launched twice and held bitwise, K2's and
    K3's launches counted under their chunked names (BWD_CHUNKED_COUNTS);
    in fp16 the CUDA-core pair it took the route from held to the same bars
    at BWD_RECORD_SHAPE. Then each dtype's pair timed there (two rounds;
    fp16's in turns against the CUDA-core pair) and at
    CHUNKED_CASES["d640"] (one). Fails after reporting every case of both
    dtypes, before any timing; returns the rows of the kernels' JSON line
    at BWD_RECORD_SHAPE, the new kernels' under the names they count
    under, the CUDA-core ones' under theirs."""
    failures, errs = [], {}
    for dtype, counts in BWD_CHUNKED_COUNTS.items():
        limits = BWD_CHUNKED_LIMITS[dtype]
        what = str(dtype)[6:]
        for name, shape in CHUNKED_CASES.items():
            D = shape[4]
            if tuple(fa.counted(fa._kernel(n, D, dtype), D)
                     for n in ("flash_dq", "flash_dkv")) != counts:
                failures.append(f"{what} {name}: not the chunked kernels' "
                                "route")
            before = dict(fa.launches)
            _, bad = kernel_errors(fa, name, shape, dtype, limits,
                                   twice=True)
            got = {n: fa.launches[n] - before[n] for n in counts}
            if got != dict.fromkeys(counts, 2):
                bad.append(f"launches {got}")
            failures += [f"{what} {name}: {b}" for b in bad]
        errs[counts], bad = kernel_errors(fa, "d640_record",
                                          BWD_RECORD_SHAPE, dtype, limits)
        failures += [f"{what} d640_record: {b}" for b in bad]
        if fa._kernel("flash_dq", 640, dtype) in OLD_BWD_ABOVE_512:
            with routed(fa, OLD_BWD_ABOVE_512):
                old, bad = kernel_errors(fa, "d640_cuda_cores",
                                         BWD_RECORD_SHAPE, dtype, limits)
            errs[tuple(OLD_BWD_ABOVE_512.values())] = old
            failures += [f"_f16_simt d640: {b}" for b in bad]
    if failures:
        raise SystemExit("K2 and K3 above D=512 failed: "
                         + "; ".join(failures))
    rows = {}
    for dtype in BWD_CHUNKED_COUNTS:
        rows.update(time_backward_turns(fa, BWD_RECORD_SHAPE, 2, dtype))
    for (dq, dkv), e in errs.items():
        rows[dq]["err"] = e["dq_abs"]
        rows[dkv]["err"] = max(e["dk_abs"], e["dv_abs"])
    for dtype in BWD_CHUNKED_COUNTS:
        time_backward_turns(fa, CHUNKED_CASES["d640"], 1, dtype)
    return rows


def backward_call(fa, q, k, v, o, do, lse, causal, q_off):
    """The port's whole attention backward, as the attention operator's
    backward runs it: K2 (dq and δ), then K3 (dk, dv) on that δ."""
    def call():
        _, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
        return fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    return call


def forward_backward(bundle, module, batch, loss_scale=1.0):
    """One forward and backward of the loss (times `loss_scale`) at the
    current weights: (loss, hidden state before the final norm,
    {parameter: gradient})."""
    hidden = []
    hook = module.final_norm.register_forward_pre_hook(
        lambda _m, args: hidden.append(args[0].detach()))
    module.zero_grad(set_to_none=True)
    loss = bundle.loss_fn(module, batch)
    (loss * loss_scale).backward()
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


def slice_gaps(bundle, module, batch, loss_scale=1.0):
    """What attention moves at init, through the kernels against the plain
    O(S²) attention on the card: the hidden state before the final norm
    (largest relative error of a token's row) and every parameter's
    gradient (largest ||g - g_plain|| / ||g_plain||). An MoE model's plain
    pass routes as the kernel pass did (RoutingReplay). Both passes
    scale the loss by `loss_scale`; the gaps are ratios, which it leaves
    alone."""
    kernel_attn, cfg = module.attn_fn, module.cfg
    replay = RoutingReplay(module) if bundle.num_experts else None
    try:
        loss_k, h_k, g_k = forward_backward(bundle, module, batch,
                                            loss_scale)
        # The plain pass runs under full remat: a policy moves no number,
        # and under "dots" the plain attention's S×S products of every
        # layer would be kept for the backward.
        module.attn_fn = None
        module.cfg = dataclasses.replace(cfg, remat_policy=None)
        if replay is not None:
            replay.replay = True
        loss_p, h_p, g_p = forward_backward(bundle, module, batch,
                                            loss_scale)
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


def check_slice(gaps, limits=SLICE_LIMITS) -> list:
    """The bars of `limits` that `gaps` breaks, logged."""
    bad = [f"{n}={gaps[n]:.3g}>{lim}" for n, lim in limits.items()
           if not gaps[n] <= lim]
    if not gaps["finite"]:
        bad.append("loss not finite")
    log("slice kernels vs plain attention: "
        + " ".join(f"{n}={v:.3g}" if isinstance(v, float) else f"{n}={v}"
                   for n, v in gaps.items())
        + (" FAIL " + ",".join(bad) if bad else " ok"))
    return bad


def train_and_count(fa, name, session, batch, want, falling=True):
    """5 steps on `batch` (finite loss, falling unless `falling` is off),
    then one counted step that must launch each kernel as often as `want`
    says (a kernel it does not name, no time); returns the counts."""
    want = {**dict.fromkeys(fa.launches, 0), **want}
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(session.train_step(batch).item())
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"{name} losses={[round(x, 6) for x in losses]} "
        f"step_ms={[round(x, 3) for x in step_ms]}")
    if not all(math.isfinite(x) for x in losses) or (
            falling and not losses[-1] < losses[0]):
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


def build_slice(model, limits=SLICE_LIMITS, loss_scale=1.0):
    """A TrainSession of `model` (a registry name or a bundle) at B=8 on
    the card, its step through the kernels checked against the plain
    attention (slice_gaps); returns (session, batch)."""
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession

    bundle = get_model(model) if isinstance(model, str) else model
    model = bundle.name
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
    if check_slice(slice_gaps(bundle, session.module, batch, loss_scale),
                   limits):
        raise SystemExit(f"{model}: the step through the kernels disagrees "
                         "with the plain attention")
    return session, batch


def run_slice(fa, model="llama_350m", tag="slice", suffix=""):
    """build_slice, then train_and_count: K1 twice a layer (full remat),
    K2 and K3 once, of the variant `suffix` names."""
    session, batch = build_slice(model)
    L = session.bundle.cfg.num_layers
    counts = train_and_count(fa, tag, session, batch,
                             {f"flash_fwd{suffix}": 2 * L,
                              f"flash_dq{suffix}": L,
                              f"flash_dkv{suffix}": L})
    return counts, session, batch


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


# Phase 11: llama_350m's width computing in fp32 and in fp16, depth cut to
# DTYPE_LAYERS so that the fp32 step stays short. fp32 takes the TF32
# forward, dQ and dK/dV (csrc/flash_f32.cu); fp16 the tensor-core forward,
# dQ and dK/dV (flash_fwd_f16, flash_dq_f16, flash_dkv_f16), and in heads
# of 256 the wide ones (`_f16_wide`; fp32's: flash_fwd_f32_wide,
# flash_dq_f32_wide, flash_dkv_f32_wide). Against the plain attention (which computes in
# fp32): fp32 differs by summation order alone, fp16 by the rounding of P
# and of the scaled dS to fp16 inside the kernels, held to the bf16
# slice's bars. fp16's
# gradients of a loss averaged over 16,384 tokens lie among its subnormals
# (below 6e-5), where the plain attention's own fp16 gradients stray from
# an fp32 twin's as far as the kernels' do; the comparison scales the loss
# by 1024, as fp16 training does (a loss scaler), which lifts them into
# fp16's normal range. The training steps are unscaled.
DTYPE_LAYERS = 4
F32_SLICE_LIMITS = {"loss": 1e-4, "hidden_row": 1e-3, "grad": 1e-3}
DTYPE_SLICES = {  # tag: (dtype, heads, bars, comparison's loss scale,
                  #       the kernels' names: K1, K2, K3)
    "float32": ("float32", 16, F32_SLICE_LIMITS, 1.0,
                ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32")),
    "float16": ("float16", 16, SLICE_LIMITS, 1024.0,
                ("flash_fwd_f16", "flash_dq_f16", "flash_dkv_f16")),
    "float16_d256": ("float16", 4, SLICE_LIMITS, 1024.0,
                     ("flash_fwd_f16_wide", "flash_dq_f16_wide",
                      "flash_dkv_f16_wide")),
    "float32_d256": ("float32", 4, F32_SLICE_LIMITS, 1.0,
                     ("flash_fwd_f32_wide", "flash_dq_f32_wide",
                      "flash_dkv_f32_wide"))}


def run_dtype_slices(fa):
    """Phase 11: for each of DTYPE_SLICES, a llama_350m-width bundle of
    DTYPE_LAYERS layers in a TrainSession on the card, its step through the
    kernels against the plain attention, 5 AdamW steps (finite, falling),
    one counted step launching the slice's K1 2L, K2 L and K3 L times and
    no other kernel. Returns the counted launches of the 64-wide slices and
    those of the `_f16_wide` and `_f32_wide` kernels and of the `_f16_simt`,
    `_f32_simt` and flash_fwd_f16_chunked ones (0: no slice runs fp16 above
    512, and no route reaches `_f32_simt`)."""
    from vodascheduler_tpu_torch.models import llama
    from vodascheduler_tpu_torch.models.registry import llama_bundle

    counts = {}
    for tag, (dtype, heads, limits, loss_scale, names) in \
            DTYPE_SLICES.items():
        cfg = dataclasses.replace(llama.LLAMA_350M, dtype=dtype,
                                  num_layers=DTYPE_LAYERS, num_heads=heads,
                                  num_kv_heads=heads // 2)
        session, batch = build_slice(
            llama_bundle(f"llama_350m_{tag}_l{DTYPE_LAYERS}", cfg, 2048),
            limits, loss_scale)
        got = train_and_count(fa, tag, session, batch,
                              dict(zip(names, (2 * DTYPE_LAYERS,
                                               DTYPE_LAYERS, DTYPE_LAYERS))))
        counts.update({k: got[k] for k in names
                       if heads == 16 or k.endswith("_wide")})
        counts.update({k: got[k] for k in got
                       if k.endswith(("_simt", "_f16_chunked"))})
        del session, batch
        gc.collect()
        torch.cuda.empty_cache()
    return counts


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
    if not fa_launches or min(fa_launches[k] for k in KERNELS) < 1:
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


# 3 steps an epoch (5 before phase 12's MoE run): A still has 9 steps and
# 3 saves to train after its first checkpoint when B preempts it.
SCHED_STEPS_PER_EPOCH, SCHED_EPOCHS = 3, {"a": 4, "b": 2}
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


# 4 steps an epoch (5 before phase 12's MoE run): A trains on while the
# monitor reads its memory at its first checkpoint.
SERVER_STEPS_PER_EPOCH, SERVER_EPOCHS = 4, 3
# The GPU monitor's sampling interval in phase 7 (the collector's).
SERVER_COLLECT_S = 5.0
GIB = 1 << 30


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _http(url: str):
    """(status, body) of a GET; (None, reason) while nothing answers."""
    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            return r.status, r.read().decode()
    except urllib.error.URLError as e:
        return None, str(e.reason)


def _compute_apps() -> list:
    """The card's compute processes as nvidia-smi lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [int(x) for x in out.split()]


def _supervisor_pids(workdir: str) -> list:
    """Processes running a supervisor of a job under `workdir`."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if (b"vodascheduler_tpu_torch.runtime.supervisor" in argv
                and any(a.startswith(workdir.encode()) for a in argv)):
            pids.append(int(d))
    return pids


def _gauge(text: str, series: str):
    m = re.search(rf'^{series}\{{accelerator="0"\}} (\S+)$', text, re.M)
    return float(m.group(1)) if m else None


def run_server():
    """Phase 7: voda-server and voda create drive two llama_350m_af jobs on
    the card; the server is stopped by SIGINT while A trains and restarted
    with --resume, and A resumes from its checkpoint. Returns the kernel
    launches the three supervisor processes report at exit, summed."""
    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        read_epoch_csv,
    )

    workdir = os.path.join(REPO, "build", "chip_smoke_server")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    sp, cp, ap = _free_ports(3)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), VODA_TPU_MONITOR="1",
               VODA_SERVICE_PORT=str(sp), VODA_SCHEDULER_PORT=str(cp),
               VODA_ALLOCATOR_PORT=str(ap), VODA_RATE_LIMIT_SECONDS="0.5")
    env.pop("VODA_FORCE_CPU_DEVICES", None)
    svc, sch = f"http://127.0.0.1:{sp}", f"http://127.0.0.1:{cp}"
    jobs_dir = os.path.join(workdir, "jobs")
    servers, seen_pids, names = [], set(), {}
    first_steps, spawned, submitted, done = {}, {}, {}, {}

    def start_server(tag, resume=False):
        with open(os.path.join(workdir, f"{tag}.log"), "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "vodascheduler_tpu_torch.service",
                 "--workdir", workdir, "--chips", "1", "--algorithm",
                 "ElasticFIFO", "--collector-interval",
                 str(SERVER_COLLECT_S)] + (["--resume"] if resume else []),
                env=env, cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True)
        servers.append((tag, proc))
        return proc

    def server_log(tag):
        return _text(workdir, f"{tag}.log")

    def job_log_path(job):
        return os.path.join(jobs_dir, names[job], "supervisor.log")

    def job_log(job):
        if not os.path.exists(job_log_path(job)):
            return ""
        with open(job_log_path(job)) as f:
            return f.read()

    def fail(why):
        raise SystemExit(
            f"server: {why}\n" + "\n".join(
                f"--- {tag}\n{server_log(tag)[-3000:]}" for tag, _ in servers)
            + "\n" + "\n".join(f"--- job {job}\n{job_log(job)[-3000:]}"
                               for job in names))

    def observe():
        now = time.monotonic()
        seen_pids.update(_supervisor_pids(workdir))
        for job in names:
            # LocalBackend opens the log as it spawns the supervisor.
            if job not in spawned and os.path.exists(job_log_path(job)):
                spawned[job] = now
            n = job_log(job).count("warmup step")
            if n > len(first_steps.setdefault(job, [])):
                first_steps[job].append(now)

    def wait(cond, what, proc, timeout=300.0):
        deadline = time.monotonic() + timeout
        while not cond():
            if proc.poll() is not None:
                fail(f"the server exited ({proc.returncode}) before {what}")
            if time.monotonic() > deadline:
                fail(f"timed out waiting for {what}")
            observe()
            time.sleep(0.1)

    def statuses():
        code, body = _http(f"{svc}/training")
        return ({j["name"]: j["status"] for j in json.loads(body)}
                if code == 200 else {})

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "vodascheduler_tpu_torch.cli", "--server",
             svc, "--scheduler-server", sch, *args], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=120)
        return proc.returncode, proc.stdout + proc.stderr

    def submit(job):
        path = os.path.join(workdir, f"{job}.yaml")
        with open(path, "w") as f:
            json.dump({"name": f"server-{job}", "pool": "default",
                       "model": "llama_350m_af", "global_batch_size": 8,
                       "steps_per_epoch": SERVER_STEPS_PER_EPOCH,
                       "config": {"min_num_chips": 1, "max_num_chips": 1,
                                  "epochs": SERVER_EPOCHS}}, f)
        submitted[job] = time.monotonic()
        rc, out = cli("create", "-f", path)
        m = re.fullmatch(r"job created: (\S+)\n", out)
        if rc != 0 or m is None:
            fail(f"voda create gave {rc}: {out}")
        names[job] = m.group(1)

    def metrics():
        return _http(f"{sch}/metrics")[1]

    def profile():
        code, body = _http(f"{sch}/debug/profile?n=100000")
        if code != 200:
            fail(f"GET /debug/profile gave {code}: {body}")
        return [r["decide_ms"] for r in json.loads(body)]

    def stop(proc, tag):
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            fail(f"the {tag} server did not exit within 300 s of SIGINT")
        if rc != 0:
            fail(f"the {tag} server exited {rc} after SIGINT")
        return time.monotonic() - t0

    apps_before = _compute_apps()
    try:
        t0 = time.monotonic()
        first = start_server("server")
        wait(lambda: _http(f"{svc}/training")[0] == 200,
             "the server to answer", first)
        up_s = time.monotonic() - t0
        wait(lambda: _gauge(metrics(), "voda_gpu_memory_bytes_in_use")
             is not None, "the GPU monitor's first reading", first)
        used_before = _gauge(metrics(), "voda_gpu_memory_bytes_in_use")
        submit("a")
        submit("b")
        a_csv = os.path.join(jobs_dir, "metrics", f"{names['a']}.csv")
        wait(lambda: os.path.exists(a_csv) and read_epoch_csv(a_csv),
             "A's first checkpoint (its epoch-0 CSV row)", first)
        # At A's first checkpoint: the monitor reads A's memory on the
        # card, and the server holds no CUDA context of its own.
        wait(lambda: (_gauge(metrics(), "voda_gpu_memory_bytes_in_use")
                      or 0.0) > used_before + GIB,
             "the gauge to read A's memory", first,
             timeout=3 * SERVER_COLLECT_S)
        text = metrics()
        used = _gauge(text, "voda_gpu_memory_bytes_in_use")
        total = _gauge(text, "voda_gpu_memory_bytes_total")
        apps = _compute_apps()
        card_total = torch.cuda.mem_get_info(0)[1]
        running = statuses()
        devices = re.search(r"^voda_gpu_devices (\S+)$", text, re.M)
        log(f"server gauges at A's first checkpoint: "
            f"voda_gpu_devices={devices and devices.group(1)} "
            f"used={used:.0f} (before A {used_before:.0f}) total={total:.0f} "
            f"(torch {card_total}) util_pct="
            f"{_gauge(text, 'voda_gpu_utilization_pct')} power_w="
            f"{_gauge(text, 'voda_gpu_power_watts')} limit_w="
            f"{_gauge(text, 'voda_gpu_power_limit_watts')}; compute apps "
            f"{apps_before} -> {apps}, server pid {first.pid}; {running}")
        if not (GIB < used <= total and abs(total - card_total)
                <= 0.01 * card_total):
            fail(f"the gauges read used {used}, total {total}; the card "
                 f"has {card_total}")
        if first.pid in apps or len(apps) != len(apps_before) + 1:
            fail(f"compute apps {apps_before} -> {apps}: the server "
                 f"(pid {first.pid}) holds a CUDA context, or A none")
        if running != {names["a"]: "Running", names["b"]: "Waiting"}:
            fail(f"at A's first checkpoint: {running}")
        passes = profile()
        sigint_s = stop(first, "first")
        observe()
        left = _supervisor_pids(workdir)
        if left:
            fail(f"supervisors {left} outlived the server")
        rc, fsck = cli("fsck", os.path.join(workdir, "journal",
                                            "default.wal"))
        if rc != 0 or '"problems": []' not in fsck:
            fail(f"fsck gave {rc}: {fsck}")
        checkpoints = re.findall(r"^checkpoint step (\d+) bytes",
                                 job_log("a"), re.M)
        log(f"server SIGINT->exit_s={sigint_s:.3f} A's checkpoints at "
            f"{checkpoints}; fsck clean: {' '.join(fsck.split())[:300]}")

        t_resume = time.monotonic()
        second = start_server("server_resume", resume=True)
        wait(lambda: _http(f"{svc}/training")[0] == 200,
             "the resumed server to answer", second)
        resume_up_s = time.monotonic() - t_resume
        a_steps = len(first_steps["a"])
        wait(lambda: len(first_steps["a"]) > a_steps,
             "A's first step after the restart", second)
        a_restart_s = first_steps["a"][-1] - t_resume
        for job in ("a", "b"):
            wait(lambda: statuses().get(names[job]) in ("Completed",
                                                        "Failed"),
                 f"{job} to end", second, timeout=600.0)
            done[job] = time.monotonic()
        passes += profile()
        rc, listing = cli("get", "jobs")
        stop(second, "resumed")
        left = _supervisor_pids(workdir)
        if left:
            fail(f"supervisors {left} outlived the resumed server")
    finally:
        for _, proc in servers:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        for pid in seen_pids | set(_supervisor_pids(workdir)):
            try:
                os.killpg(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    logs = {job: job_log(job) for job in names}
    listed = dict(re.findall(r"^(\S+)\s+default\s+(\S+)", listing, re.M))
    launches = {job: [json.loads(m) for m in re.findall(
        r"^kernel launches (.*)$", logs[job], re.M)] for job in names}
    resumed = [int(n) for n in re.findall(r"resumed at step (\d+) on 1 chips",
                                          logs["a"])]
    losses = {job: _epoch_losses(logs[job]) for job in names}
    rows = {job: [r["epoch"] for r in read_epoch_csv(os.path.join(
        jobs_dir, "metrics", f"{names[job]}.csv"))] for job in names}
    for job in names:
        log(f"server[{job}] {listed.get(names[job])} submit->first_step_s="
            f"{first_steps[job][0] - submitted[job]:.3f} submit->end_s="
            f"{done[job] - submitted[job]:.3f} epoch_losses={losses[job]} "
            f"csv_epochs={rows[job]} launches={launches[job]}")
    log(f"server up_s={up_s:.3f} SIGINT->exit_s={sigint_s:.3f} "
        f"--resume->up_s={resume_up_s:.3f} A restart->first_step_s="
        f"{a_restart_s:.3f} resumed_at={resumed}")
    log(f"server B wait: submit->spawn_s="
        f"{spawned['b'] - submitted['b']:.3f} B submit->completed_s="
        f"{done['b'] - submitted['b']:.3f}")
    log(f"server makespan_s={max(done.values()) - submitted['a']:.3f} "
        f"passes={len(passes)} median_decide_ms="
        f"{statistics.median(passes):.3f}")

    bad = []
    want = [str(e) for e in range(SERVER_EPOCHS)]
    if rc != 0 or listed != {names[j]: "Completed" for j in names}:
        bad.append(f"voda get jobs gave {rc}: {listing}")
    if (len(resumed) != 1 or resumed[0] < SERVER_STEPS_PER_EPOCH
            or [str(resumed[0])] != checkpoints[-1:]):
        bad.append(f"A resumed at {resumed}; its checkpoints {checkpoints}")
    if not spawned["b"] >= done["a"] - 1.0 or len(first_steps["b"]) != 1:
        bad.append("B ran beside A")
    for job in names:
        if rows[job] != want:
            bad.append(f"{job}'s CSV epochs {rows[job]}")
    counts = [c for job in names for c in launches[job]]
    if ([len(launches[j]) for j in names] != [2, 1]
            or any(min(c[k] for k in KERNELS) < 1 for c in counts)):
        bad.append(f"kernel launches {launches}")
    last = SERVER_EPOCHS - 1
    gap = abs(losses["a"].get(last, math.nan)
              - losses["b"].get(last, math.nan)) \
        / abs(losses["b"].get(last, math.nan))
    log(f"server epoch-{last} loss A={losses['a'].get(last)} "
        f"B={losses['b'].get(last)} rel_gap={gap:.3g} (bar 1e-3)")
    if not gap <= 1e-3:
        bad.append("A's and B's last-epoch losses differ")
    if bad:
        fail("; ".join(bad))
    shutil.rmtree(workdir)
    return {k: sum(c[k] for c in counts) for k in KERNELS}


# ---------------------------------------------------------------------------
# the model families at full width (phase 9)
# ---------------------------------------------------------------------------

# The families driven at their published widths, B=8: each bundle's own
# synthetic batch, or the real digits; llama_350m_text on the real corpus.
FAMILIES = ("mnist_mlp", "digits_mlp", "resnet50", "bert_base", "vit_l16",
            "nmt_base")
# bf16 against an fp32 twin of the same weights: the step-0 loss, relative,
# and each gradient's largest difference over its own largest value (the
# bars of phase 4's comparison).
TWIN_LIMITS = {"loss": 2e-2, "grad": 5e-2}
# resnet50's bf16 gradients are further from fp32 than TWIN_LIMITS at
# every seed, the reference's too (0.076 at its seed, scripts/
# reference_twin_gap.py), and the gap moves more with the seed than a
# precision fault moves it at one seed: conv_init's weight gradient, a sum
# over B·112² positions, at the end of 53 bf16 convolutions whose
# BatchNorm normalises nothing. scripts/resnet_twin_gap.py on the card,
# seeds 0-7: sound 0.075-0.161 (exact fp32 sums read the same, so it is
# not cuDNN's arithmetic); one convolution at 5 mantissa bits adds
# 0.003-0.05 at a seed. Over 8 seeds (weights and batch) the means
# separate: sound 0.115, the smallest planted fault 0.153. So resnet50's
# reading is the mean of its worst gradient gap over TWIN_SEEDS seeds.
TWIN_SEEDS = {"resnet50": 8}
TWIN_GRAD_LIMITS = {"resnet50": 0.135}


def twin_gaps(bundle, module, batch):
    """One forward and backward of `module` (the bundle's dtype, its
    kernels if it has them) against an fp32 twin with the same weights
    and the plain attention, on `batch`: {"loss": relative gap, "grad":
    worst max|g - g_twin| / max|g_twin| over the parameters, "grad_param":
    where, "finite": the loss is}. Convolutions of the twin run in full
    fp32 (cuDNN's TF32 off)."""
    cfg = module.cfg
    twin_cfg = (dataclasses.replace(cfg, dtype="float32")
                if hasattr(cfg, "dtype") else cfg)
    device = next(module.parameters()).device
    twin = type(module)(twin_cfg, device=device)
    twin.load_state_dict(module.state_dict())

    def loss_and_grads(m):
        m.zero_grad(set_to_none=True)
        loss = bundle.loss_fn(m, batch)
        loss.backward()
        grads = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.item(), grads

    loss, grads = loss_and_grads(module)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        loss_t, grads_t = loss_and_grads(twin)
    del twin
    gap = {n: ((grads[n] - grads_t[n]).abs().max()
               / grads_t[n].abs().max().clamp_min(1e-30)).item()
           for n in grads_t}
    worst = max(gap, key=gap.get)
    return {"loss": abs(loss - loss_t) / abs(loss_t), "grad": gap[worst],
            "grad_param": worst, "finite": math.isfinite(loss),
            "loss_bf16": loss, "loss_fp32": loss_t}


def family_twin(name, session, batch) -> dict:
    """twin_gaps of family `name` on `session` (seed 0) and `batch`, or,
    for a name of TWIN_SEEDS, over that many seeds: the worst loss gap,
    the mean of the worst gradient gaps (each seed's in "grad_by_seed"),
    seed 0's worst parameter, and whether every loss is finite."""
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession

    readings = [twin_gaps(session.bundle, session.module, batch)]
    for seed in range(1, TWIN_SEEDS.get(name, 1)):
        other = TrainSession(get_model(name), 1, global_batch_size=8,
                             seed=seed)
        readings.append(twin_gaps(other.bundle, other.module,
                                  other.make_batch()))
        del other
    if len(readings) == 1:
        return readings[0]
    return {"loss": max(r["loss"] for r in readings),
            "grad": statistics.fmean(r["grad"] for r in readings),
            "grad_by_seed": [round(r["grad"], 6) for r in readings],
            "grad_param": readings[0]["grad_param"],
            "finite": all(r["finite"] for r in readings)}


def check_twin(name, gaps) -> list:
    limits = dict(TWIN_LIMITS, grad=TWIN_GRAD_LIMITS.get(
        name, TWIN_LIMITS["grad"]))
    bad = [f"{n}={gaps[n]:.3g}>{lim}" for n, lim in limits.items()
           if not gaps[n] <= lim]
    if not gaps["finite"]:
        bad.append("loss not finite")
    log(f"family[{name}] bf16 vs fp32 twin: "
        + " ".join(f"{n}={v:.6g}" if isinstance(v, float) else f"{n}={v}"
                   for n, v in gaps.items())
        + (" FAIL " + ",".join(bad) if bad else " ok"))
    return bad


def family_step_report(name, session, batch, steps=3):
    """`steps` steps on one batch, timed: the losses, step ms (median of
    those after the first), throughput and peak memory; logged."""
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(session.train_step(batch).item())
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    steady = statistics.median(step_ms[1:])
    per_step = (session.global_batch_size * session.bundle.seq_len
                if session.bundle.seq_len else session.global_batch_size)
    unit = "tokens" if session.bundle.seq_len else "images"
    log(f"family[{name}] losses={[round(x, 6) for x in losses]} "
        f"step_ms={[round(x, 3) for x in step_ms]} "
        f"step_ms_steady={steady:.3f} {unit}_per_s="
        f"{per_step / steady * 1e3:.1f} peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} params="
        f"{sum(p.numel() for p in session.module.parameters())}")
    return losses


def run_families(fa):
    """Phase 9: every family that fits one card, at full width, through
    TrainSession on the card. Each: its bf16 step against an fp32 twin
    (TWIN_LIMITS), 3 steps (finite; digits_mlp's falling) with no kernel
    launched (no `attn_fn`: the plain attention, as in the reference).
    llama_350m_text: the twin check, then phase 4's checks (the kernels
    against the plain attention, 5 finite steps, 48/24/24 launches).
    Then a llama_350m-width bundle with 4 heads of 256 (a user's model the
    JAX package trains) through the wide kernels, launches 48/24/24.
    Returns the counted launches of the two Llama runs."""
    from vodascheduler_tpu_torch.models import get_model, llama
    from vodascheduler_tpu_torch.models.registry import llama_bundle
    from vodascheduler_tpu_torch.runtime import TrainSession

    failures = []
    for name in FAMILIES:
        t0 = time.perf_counter()
        session = TrainSession(get_model(name), 1, global_batch_size=8)
        batch = session.make_batch()
        failures += [f"{name}: {b}" for b in check_twin(
            name, family_twin(name, session, batch))]
        fa.reset_launches()
        losses = family_step_report(name, session, batch)
        if any(fa.launches.values()):
            failures.append(f"{name}: launched {fa.launches}")
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"{name}: losses {losses}")
        if name == "digits_mlp" and not losses[-1] < losses[0]:
            failures.append(f"{name}: loss not falling {losses}")
        log(f"family[{name}] phase_s={time.perf_counter() - t0:.1f}")
        del session, batch
        gc.collect()
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit("families: " + "; ".join(failures))

    session, batch = build_slice("llama_350m_text")
    if check_twin("llama_350m_text",
                  twin_gaps(session.bundle, session.module, batch)):
        raise SystemExit("families: llama_350m_text's bf16 step disagrees "
                         "with its fp32 twin")
    L = session.bundle.cfg.num_layers
    # The byte-level model on one batch of real text does not fall step by
    # step at the bundles' learning rate (1e-3, no warmup), the frequent
    # bytes' rows all moving by lr at once: the JAX package's own first
    # steps read 6.19, 5.49, 11.30, 5.18, 8.47 in fp32 at S=256, and the
    # port's in fp32 at this S=2048 6.15, 6.05, 11.22, 6.65, 5.31, where
    # the fifth falls below the first or not by the batch
    # (scripts/text_lm_first_steps.py). Its falling loss is held over the
    # job's 80 steps instead (phase 8: the last epoch below the first).
    counts = train_and_count(
        fa, "text", session, batch,
        {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}, falling=False)
    del session, batch
    gc.collect()
    torch.cuda.empty_cache()
    wide_cfg = dataclasses.replace(llama.LLAMA_350M, num_heads=4,
                                   num_kv_heads=2)
    wide, session, _ = run_slice(
        fa, llama_bundle("llama_350m_d256", wide_cfg, 2048), "d256",
        suffix="_wide")
    del session
    gc.collect()
    torch.cuda.empty_cache()
    return {**counts, **{k: v for k, v in wide.items() if "_wide" in k}}


# ---------------------------------------------------------------------------
# the repo's one-card example jobs through the server (phase 8)
# ---------------------------------------------------------------------------

EXAMPLE_JOBS = ("examples/jobs/llama-real-text.yaml",
                "examples/jobs/digits-real-data.yaml",
                "examples/torch/custom-cnn.yaml")


def run_example_jobs(jobs=EXAMPLE_JOBS, hermetic=False):
    """Phase 8: `python -m vodascheduler_tpu_torch.service` on one card
    (ElasticFIFO) takes the repo's one-card example jobs from `cli create
    -f`, as they are: llama-real-text, digits-real-data, then the port's
    custom CNN. Each must reach Completed with one CSV row per epoch; the
    text job must launch K1, K2 and K3 and end its last epoch below its
    first epoch's loss. Printed: each job's submit -> first step and
    submit -> completed. `jobs` and `hermetic` (the server on a CPU
    "card", jobs under VODA_FORCE_CPU_DEVICES) are for a rehearsal off the
    card."""
    import yaml

    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        read_epoch_csv,
    )

    workdir = os.path.join(REPO, "build", "chip_smoke_examples")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    sp, cp, ap = _free_ports(3)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               VODA_SERVICE_PORT=str(sp), VODA_SCHEDULER_PORT=str(cp),
               VODA_ALLOCATOR_PORT=str(ap), VODA_RATE_LIMIT_SECONDS="0.5")
    if not hermetic:
        env.pop("VODA_FORCE_CPU_DEVICES", None)
    svc, sch = f"http://127.0.0.1:{sp}", f"http://127.0.0.1:{cp}"
    jobs_dir = os.path.join(workdir, "jobs")
    specs = {}
    for path in jobs:
        with open(os.path.join(REPO, path)) as f:
            specs[path] = yaml.safe_load(f)
    names, submitted, first_step, done = {}, {}, {}, {}
    log_path = os.path.join(workdir, "server.log")
    with open(log_path, "w") as out:
        server = subprocess.Popen(
            [sys.executable, "-m", "vodascheduler_tpu_torch.service",
             "--workdir", workdir, "--chips", "1", "--algorithm",
             "ElasticFIFO"] + (["--hermetic-devices", "1"] if hermetic
                               else []), env=env, cwd=REPO, stdout=out,
            stderr=subprocess.STDOUT, start_new_session=True)

    def job_log(path):
        f = os.path.join(jobs_dir, names[path], "supervisor.log")
        return _text(os.path.dirname(f), "supervisor.log") \
            if os.path.exists(f) else ""

    def fail(why):
        raise SystemExit(f"examples: {why}\n--- server\n"
                         + _text(workdir, "server.log")[-3000:] + "\n"
                         + "\n".join(f"--- {p}\n{job_log(p)[-3000:]}"
                                     for p in names))

    def statuses():
        code, body = _http(f"{svc}/training")
        return ({j["name"]: j["status"] for j in json.loads(body)}
                if code == 200 else {})

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "vodascheduler_tpu_torch.cli", "--server",
             svc, "--scheduler-server", sch, *args], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=120)
        return proc.returncode, proc.stdout + proc.stderr

    def wait(cond, what, timeout):
        deadline = time.monotonic() + timeout
        while not cond():
            if server.poll() is not None:
                fail(f"the server exited ({server.returncode}) before {what}")
            if time.monotonic() > deadline:
                fail(f"timed out waiting for {what}; {statuses()}")
            now = time.monotonic()
            for p in names:
                if p not in first_step and "warmup step" in job_log(p):
                    first_step[p] = now
                if p not in done and statuses().get(names[p]) in (
                        "Completed", "Failed"):
                    done[p] = now
            time.sleep(0.2)

    try:
        wait(lambda: _http(f"{svc}/training")[0] == 200,
             "the server to answer", 120)
        for path in jobs:
            submitted[path] = time.monotonic()
            rc, out = cli("create", "-f", os.path.join(REPO, path))
            m = re.fullmatch(r"job created: (\S+)\n", out)
            if rc != 0 or m is None:
                fail(f"voda create -f {path} gave {rc}: {out}")
            names[path] = m.group(1)
        wait(lambda: len(done) == len(jobs), "the jobs to end", 900)
        rc, listing = cli("get", "jobs")
        server.send_signal(signal.SIGINT)
        server.wait(timeout=120)
    finally:
        if server.poll() is None:
            os.killpg(server.pid, signal.SIGKILL)
            server.wait()
        for pid in _supervisor_pids(workdir):
            try:
                os.killpg(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    bad = []
    final = statuses() or dict(re.findall(r"^(\S+)\s+default\s+(\S+)",
                                          listing, re.M))
    for path in jobs:
        text = job_log(path)
        losses = _epoch_losses(text)
        epochs = specs[path]["config"]["epochs"]
        rows = [r["epoch"] for r in read_epoch_csv(os.path.join(
            jobs_dir, "metrics", f"{names[path]}.csv"))]
        launches = [json.loads(m) for m in re.findall(
            r"^kernel launches (.*)$", text, re.M)]
        status = final.get(names[path])
        log(f"examples[{specs[path]['name']}] model={specs[path]['model']} "
            f"status={status} submit->first_step_s="
            f"{first_step.get(path, math.nan) - submitted[path]:.3f} "
            f"submit->completed_s={done[path] - submitted[path]:.3f} "
            f"epoch_losses={losses} csv_epochs={rows} launches={launches}")
        if rows != [str(e) for e in range(epochs)] or sorted(losses) != list(
                range(epochs)):
            bad.append(f"{path}: csv epochs {rows}, loss lines {losses}")
        if path.endswith("llama-real-text.yaml"):
            if not launches or any(min(c[k] for k in KERNELS) < 1
                                   for c in launches):
                bad.append(f"{path}: kernel launches {launches}")
            if not losses.get(epochs - 1, math.inf) < losses.get(0, -1):
                bad.append(f"{path}: last-epoch loss not below the first")
    if rc != 0 or sorted(final.get(n) for n in names.values()) != [
            "Completed"] * len(jobs):
        bad.append(f"statuses {final}; voda get jobs gave {rc}: {listing}")
    if bad:
        fail("; ".join(bad))
    shutil.rmtree(workdir)


# ---------------------------------------------------------------------------
# what a resize costs on the card (phase 10)
# ---------------------------------------------------------------------------

RESIZE_MODEL, RESIZE_BATCH = "llama_350m", 8
RESIZE_SEGMENTS = ("proc_start_ms", "torch_imported_ms", "cuda_ready_ms",
                   "kernels_loaded_ms", "setup_built_ms", "restored_ms",
                   "first_step_done_ms")
# The restart child's first-step loss against the prepare child's same step
# (phase 5b's bar), and checkpoint_bytes against the state's tensor bytes
# (the rest is the checkpoint's metadata and record headers).
RESIZE_LOSS_LIMIT = 1e-3
RESIZE_BYTES_LIMIT = 1e-2
# One step of llama_350m (full remat: K1 twice a layer).
RESIZE_LAUNCHES = {"flash_fwd": 48, "flash_dq": 24, "flash_dkv": 24}
# The fast child's first step after its in-place resize against the prepare
# child's same step: the same arithmetic on the same state, on a rank of
# one (phase 12 held that path within 4.7e-8 of the one-card session).
FAST_LOSS_LIMIT = 1e-5
# Steps a child takes with its kernels counted: prepare 3 warm steps, one
# before the synced save and the 2 after it; restart 2 after the restore;
# fast the first step after the resize.
RESIZE_COUNTED_STEPS = {"prepare": 6, "restart": 2, "fast": 1}


def resize_faults(rows: dict, total_bytes: int) -> list:
    """Phase 10's checks of the benchrunner's meta and resize rows."""
    from vodascheduler_tpu_torch.replay import restart_costs

    bad = [f"{pid}: {r['provenance']} {r.get('error', '')}"
           for pid, r in rows.items() if r["provenance"] != "measured"]
    if bad:
        return bad
    (row,) = [r for r in rows.values() if r["kind"] == "resize"]
    d = row["data"]
    seg = d["restart_segments_ms"]
    missing = [k for k in RESIZE_SEGMENTS if not seg.get(k, -1) >= 0]
    if missing or set(seg) != set(RESIZE_SEGMENTS):
        bad.append(f"segments {seg}: missing or negative {missing}")
    elif not (abs(sum(seg.values()) - d["restart_total_ms"])
              <= 1.0 * len(seg)):
        bad.append(f"segments sum to {sum(seg.values())} ms, total "
                   f"{d['restart_total_ms']} ms")
    if not (abs(d["checkpoint_bytes"] - d["state_bytes"])
            <= RESIZE_BYTES_LIMIT * d["state_bytes"]):
        bad.append(f"checkpoint_bytes {d['checkpoint_bytes']} against the "
                   f"state's {d['state_bytes']}")
    paths = {p["path"]: p for p in d["resize_paths"]}
    if paths["cold"]["seconds"] != d["resize_cost_seconds"]:
        bad.append(f"cold row {paths['cold']} against resize_cost_seconds "
                   f"{d['resize_cost_seconds']}")
    fast_ms = d.get("fast_resize_ms")
    if (d.get("fast_error") or not fast_ms or fast_ms <= 0
            or paths["fast"] != {"path": "fast",
                                 "seconds": round(fast_ms / 1000.0, 2),
                                 "from_chips": 1, "to_chips": 1}):
        bad.append(f"fast row {paths['fast']} fast_resize_ms {fast_ms} "
                   f"error {d.get('fast_error')}")
    else:
        a, b = d["prepare_next_step_loss"], d["fast_first_step_loss"]
        if not (math.isfinite(b) and abs(b - a) <= FAST_LOSS_LIMIT * abs(a)):
            bad.append(f"first-step loss {b} after the in-place resize "
                       f"against {a}")
        before, peak = d["fast_memory_before_bytes"], d["fast_peak_bytes"]
        if not (before and peak and before < peak <= total_bytes):
            bad.append(f"device memory across the resize: {before} before, "
                       f"peak {peak} (at most {total_bytes})")
    peaks = [m["allocated_bytes.all.peak"]
             for child in (row.get("telemetry") or {}).values()
             for m in child.get("memory", {}).values()]
    if not peaks or not GIB < max(peaks) <= total_bytes:
        bad.append(f"telemetry peaks {peaks} (want above 1 GiB, at most "
                   f"{total_bytes})")
    if set(d["launches"]) != set(RESIZE_COUNTED_STEPS):
        bad.append(f"launches of {sorted(d['launches'])}")
    for child, launches in d["launches"].items():
        want = {k: v * RESIZE_COUNTED_STEPS.get(child, 0)
                for k, v in RESIZE_LAUNCHES.items()}
        if launches != want:
            bad.append(f"{child} child launched {launches}, want {want}")
    if d["kernel_cache_hit"] is not True:
        bad.append("the restart child did not find its kernels built")
    for step in ("first", "second"):
        a = d["prepare_next_step_loss" if step == "first"
              else "prepare_second_step_loss"]
        b = d[f"restart_{step}_step_loss"]
        if not (math.isfinite(a) and abs(b - a) <= RESIZE_LOSS_LIMIT * abs(a)):
            bad.append(f"{step}-step loss {b} after the restart against {a}")
    if not restart_costs._complete(d):
        bad.append("the row is not a complete point for restart_costs")
    else:
        for fam, cost in restart_costs.derive_costs([d]).items():
            if not (math.isfinite(cost.restart_s)
                    and f"measured on {RESIZE_MODEL})" in cost.provenance
                    and f"measured on {RESIZE_MODEL})"
                    in cost.inplace_provenance):
                bad.append(f"{fam}: {cost}")
    return bad


def run_resize(card: str) -> None:
    """Phase 10: the port's benchrunner over meta and resize:llama_350m:b8
    (the resize bench's prepare, restart and fast children on the card),
    in a fresh workdir with no cache."""
    from vodascheduler_tpu_torch.benchrunner import (
        BenchOrchestrator,
        default_registry,
    )
    from vodascheduler_tpu_torch.replay import restart_costs

    workdir = os.path.join(REPO, "build", "chip_smoke_resize")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    points = default_registry(attention_points=(), moe_batch=None,
                              resize_points=[(RESIZE_MODEL, RESIZE_BATCH)],
                              ici_points=())
    summary = BenchOrchestrator(
        points, repo_dir=REPO,
        cache_path=os.path.join(workdir, "cache.json"),
        journal_path=os.path.join(workdir, "journal.jsonl"),
        env=dict(os.environ, TMPDIR=workdir)).run()
    rows = {r["point_id"]: r for r in summary["rows"]}
    for r in rows.values():
        log(f"resize row {json.dumps(r)}")
    bad = resize_faults(rows, torch.cuda.get_device_properties(0).total_memory)
    if bad:
        raise SystemExit("resize: " + "; ".join(bad))
    d = rows[f"resize:{RESIZE_MODEL}:b{RESIZE_BATCH}"]["data"]
    log(f"resize {RESIZE_MODEL} B={RESIZE_BATCH} on {card}: segments_ms "
        f"{json.dumps(d['restart_segments_ms'])} restart_total_ms "
        f"{d['restart_total_ms']} checkpoint_bytes {d['checkpoint_bytes']} "
        f"save_async_initiate_ms {d['save_async_initiate_ms']} "
        f"save_async_drain_ms {d['save_async_drain_ms']} save_sync_ms "
        f"{d['save_sync_ms']} (host copy {d['save_sync_host_copy_ms']}, "
        f"write {d['save_sync_write_ms']}) warm_step_ms {d['warm_step_ms']} "
        f"resize_cost_seconds {d['resize_cost_seconds']} first-step loss "
        f"{d['restart_first_step_loss']} against "
        f"{d['prepare_next_step_loss']}, second-step loss "
        f"{d['restart_second_step_loss']} against "
        f"{d['prepare_second_step_loss']}")
    log(f"resize fast {RESIZE_MODEL} B={RESIZE_BATCH} on {card}: "
        f"fast_resize_ms {d['fast_resize_ms']} (in place "
        f"{d['fast_from_chips']} -> {d['fast_to_chips']} chips, one NCCL "
        f"rank: resize(1) and the first step) beside the cold "
        f"resize_cost_seconds {d['resize_cost_seconds']} "
        f"(fast_over_cold "
        f"{d['fast_resize_ms'] / 1000.0 / d['resize_cost_seconds']:.4f}); "
        f"device memory {d['fast_memory_before_bytes']} bytes before the "
        f"resize, peak {d['fast_peak_bytes']} across it "
        f"({d['fast_peak_bytes'] / d['fast_memory_before_bytes']:.3f}x); "
        f"segments_ms {json.dumps(d['fast_segments_ms'])}; "
        f"first-step loss {d['fast_first_step_loss']} against "
        f"{d['prepare_next_step_loss']}; launches "
        f"{json.dumps(d['launches']['fast'])}")
    for fam, cost in restart_costs.derive_costs([d]).items():
        log(f"resize family {fam} on {card}: restart_s {cost.restart_s} "
            f"({cost.provenance}) inplace_s {cost.inplace_s} "
            f"({cost.inplace_provenance})")
    shutil.rmtree(workdir)


# ---------------------------------------------------------------------------
# one job on a process group: the supervisor's rendezvous (phase 12)
# ---------------------------------------------------------------------------

# llama_350m through the supervisor, 6 steps an epoch, 3 epochs. Run A: the
# coordinator's environment for one process (the agent, one NCCL rank,
# every parameter a DTensor), SIGTERMed after its epoch (steps 0-5): it
# stops at the next epoch's start, its epoch's save the checkpoint; run B:
# the one-card path (no coordinator) resumes A's sharded checkpoint,
# SIGTERMed likewise (steps 6-11); run C: the rank again, resuming B's plain
# checkpoint, to the end (steps 12-17). One save a run (4.2 GB, ~9 s to
# write), and the timed steps of each run's epoch overlap no write. Every
# step's loss (printed in the rank by the probe below) within DIST_LOSS_REL
# of the plain TrainSession's same step.
DIST_STEPS_PER_EPOCH, DIST_EPOCHS = 6, 3
DIST_LOSS_REL = 1e-3  # phase 5b's bar
DIST_LAUNCHES = {"flash_fwd": 48, "flash_dq": 24, "flash_dkv": 24}

# The job's user script: the job's model, its loss printed at every step
# and its parameters' types and meshes at the first, from inside the rank.
# With WAIT_FOR_COMMAND the first step of a run waits (at most 120 s) until
# the job's control channel holds a command, so that llama_350m's run A
# reads the phase's first resize at the boundary after that step, within
# its first epoch.
DIST_PROBE = """
import os
import time

from vodascheduler_tpu_torch.models import get_model as _get

COMMAND = {command!r}
WAIT_FOR_COMMAND = {wait!r}


def get_model(spec):
    bundle = _get(spec.model)
    loss_fn = bundle.loss_fn
    calls = [0]

    def probed(module, batch):
        if calls[0] == 0:
            deadline = time.monotonic() + 120.0
            while (WAIT_FOR_COMMAND and not os.path.exists(COMMAND)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            from torch.distributed.tensor import DTensor
            params = list(module.parameters())
            meshes = sorted({{str(p.device_mesh) for p in params
                              if isinstance(p, DTensor)}})
            print(f"probe params {{len(params)}} dtensor "
                  f"{{sum(isinstance(p, DTensor) for p in params)}} "
                  f"meshes {{meshes}}", flush=True)
        loss = loss_fn(module, batch)
        print(f"probe loss {{calls[0]}} {{loss.item():.9g}}", flush=True)
        calls[0] += 1
        time.sleep({delay})
        return loss

    bundle.loss_fn = probed
    return bundle
"""


def parse_dist_run(text: str) -> dict:
    """What a phase-12 supervisor run printed: the distributed line, the
    probe's parameter count and DTensors, each step's loss (by the step it
    trained: the probe counts from the run's first step), the launches, the
    checkpoint line, the resumed step and the restore seconds."""
    out = {"backend": None, "plan": None, "params": None, "dtensor": None,
           "meshes": None, "losses": {}, "launches": None,
           "checkpoint": None, "resumed": None, "restore_s": None}
    m = re.search(r"^distributed rank 0 of (\d+) backend (\S+) plan "
                  r"(MeshPlan\([^)]*\)) params (\S+)$", text, re.M)
    if m:
        out["backend"], out["plan"] = m.group(2), m.group(3)
    m = re.search(r"^probe params (\d+) dtensor (\d+) meshes (.*)$", text,
                  re.M)
    if m:
        out["params"], out["dtensor"] = int(m.group(1)), int(m.group(2))
        out["meshes"] = m.group(3)
    m = re.search(r"^resumed at step (\d+) on (\d+) chips$", text, re.M)
    out["resumed"] = int(m.group(1)) if m else None
    start = out["resumed"] or 0
    for m in re.finditer(r"^probe loss (\d+) (\S+)$", text, re.M):
        out["losses"][start + int(m.group(1))] = float(m.group(2))
    m = re.search(r"^kernel launches (.*)$", text, re.M)
    out["launches"] = json.loads(m.group(1)) if m else None
    m = re.search(r"^checkpoint step (\d+) bytes (\d+) host_copy_s (\S+) "
                  r"write_s (\S+)$", text, re.M)
    if m:
        out["checkpoint"] = (int(m.group(1)), int(m.group(2)),
                             float(m.group(3)), float(m.group(4)))
    m = re.search(r"^restore took (\S+) s$", text, re.M)
    out["restore_s"] = float(m.group(1)) if m else None
    return out


def dist_run_faults(run: dict, rc: int, plain: list, distributed: bool,
                    start: int, want_rc: int, falling: bool = False,
                    backend: str = "nccl",
                    launches: dict = DIST_LAUNCHES) -> list:
    """Phase 12's bars on one parsed run (parse_dist_run) that exited `rc`:
    the path (NCCL and every parameter a DTensor, or neither), the exit,
    the resumed step, each trained step's loss finite and within
    DIST_LOSS_REL of `plain` (the plain session's losses by step), falling
    from the first to the last if `falling`, DIST_LAUNCHES a step, and the
    checkpoint at the step reached when the run was stopped. `backend` and
    `launches` are the card's; the CPU rehearsal passes gloo and none."""
    bad = []
    if rc != want_rc:
        bad.append(f"exit {rc}, want {want_rc}")
    if distributed:
        if run["backend"] != backend:
            bad.append(f"backend {run['backend']}, want {backend}")
        if not run["params"] or run["dtensor"] != run["params"]:
            bad.append(f"{run['dtensor']} of {run['params']} parameters "
                       "are DTensors")
    elif run["backend"] is not None or run["dtensor"] != 0:
        bad.append(f"the one-card path ran backend {run['backend']} with "
                   f"{run['dtensor']} DTensors")
    if (run["resumed"] or 0) != start:
        bad.append(f"resumed at {run['resumed']}, want {start}")
    steps = sorted(run["losses"])
    if not steps or steps != list(range(start, steps[-1] + 1)):
        bad.append(f"steps {steps} from {start}")
        return bad
    for step in steps:
        got, want = run["losses"][step], plain[step]
        if not (math.isfinite(got) and abs(got - want)
                <= DIST_LOSS_REL * abs(want)):
            bad.append(f"step {step} loss {got} against {want}")
    if falling and not run["losses"][steps[-1]] < run["losses"][steps[0]]:
        bad.append(f"losses do not fall: {run['losses']}")
    n = len(steps)
    want_launches = {k: launches.get(k, 0) * n for k in DIST_LAUNCHES}
    got = {k: (run["launches"] or {}).get(k) for k in DIST_LAUNCHES}
    if got != want_launches:
        bad.append(f"launches {got} over {n} steps, want {want_launches}")
    if want_rc == 3 and (run["checkpoint"] is None
                         or run["checkpoint"][0] != steps[-1] + 1):
        bad.append(f"checkpoint {run['checkpoint']} after step {steps[-1]}")
    return bad


def dist_resize_faults(acks: list) -> list:
    """Phase 12's bars on run A's two resize acks: a resize to 1 acked in
    place at a step of its first epoch, one to 2 nacked restart_required
    (one rank: a grow needs a process-group change)."""
    bad = []
    first, second = acks
    if not (first and first.get("ok") and first.get("path") == "inplace"
            and first.get("num_chips") == 1
            and 0 < first.get("step", 0) <= DIST_STEPS_PER_EPOCH):
        bad.append(f"the resize to 1: {first}")
    if not (second and second.get("ok") is False
            and second.get("path") == "restart_required"
            and "2 needs a process-group change" in second.get("reason",
                                                             "")):
        bad.append(f"the resize to 2: {second}")
    return bad


def _dist_launches(run: dict) -> dict:
    return {k: (run["launches"] or {}).get(k) for k in DIST_LAUNCHES}


def _dist_supervisor(workdir: str, tag: str, coordinator: bool,
                     hermetic: bool):
    """The supervisor of phase 12's job; with `coordinator`, the agent of
    one process at a free port; `hermetic`: on one CPU device."""
    out = open(os.path.join(workdir, f"{tag}.out"), "w")
    err = open(os.path.join(workdir, f"{tag}.err"), "w")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for name in ("VODA_FORCE_CPU_DEVICES", "VODA_COORDINATOR_ADDRESS",
                 "VODA_NUM_PROCESSES", "VODA_PROCESS_ID"):
        env.pop(name, None)
    if hermetic:
        env["VODA_FORCE_CPU_DEVICES"] = "1"
    if coordinator:
        env.update({"VODA_COORDINATOR_ADDRESS":
                    f"127.0.0.1:{_free_ports(1)[0]}",
                    "VODA_NUM_PROCESSES": "1", "VODA_PROCESS_ID": "0"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "vodascheduler_tpu_torch.runtime.supervisor",
         "--workdir", workdir, "--num-chips", "1"],
        stdout=out, stderr=err, cwd=REPO, env=env)
    out.close()
    err.close()
    return proc


def run_distributed(card: str, hermetic: bool = False) -> None:
    """Phase 12: llama_350m through the supervisor's rendezvous at world
    size 1 (NCCL, a DeviceMesh, every parameter a DTensor, K1-K3 on the
    rank's local tensors), against the plain one-card session; a sharded
    checkpoint resumed on the one-card path and a plain one resumed in the
    rank; the distributed path's step time beside the one-card path's, the
    saves and the restores. `hermetic` rehearses it on the CPU: llama_tiny
    on one CPU device, gloo, no kernel, 8 epochs of 2 steps, each step
    slowed by 0.3 s. There a save's host copy takes no time, so a SIGTERM
    after an epoch's line lands in the next epoch, and a run stops one or
    two epochs later than on the card."""
    from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        read_epoch_csv,
    )
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession
    from vodascheduler_tpu_torch.runtime.supervisor import (
        read_resize_ack,
        request_resize,
    )

    steps_per_epoch, epochs = ((2, 8) if hermetic
                               else (DIST_STEPS_PER_EPOCH, DIST_EPOCHS))
    total = steps_per_epoch * epochs
    model = "llama_tiny" if hermetic else "llama_350m"
    session = TrainSession(get_model(model), 1, global_batch_size=8,
                           device="cpu" if hermetic else None)
    plain, plain_ms = [], []
    for _ in range(total):
        t0 = time.perf_counter()
        plain.append(session.train_step(session.make_batch()).item())
        if not hermetic:
            torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t0))
    del session
    gc.collect()
    if not hermetic:
        torch.cuda.empty_cache()
    log(f"dist plain session losses={[round(x, 6) for x in plain]} "
        f"step_ms={statistics.median(plain_ms[1:]):.3f} (median of steps "
        f"2-{total}) card={card}")

    workdir = os.path.join(REPO, "build", "chip_smoke_dist"
                           + ("_hermetic" if hermetic else ""))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    name = f"{model}_dist"
    with open(os.path.join(workdir, "probe.py"), "w") as f:
        f.write(DIST_PROBE.format(
            delay=0.3 if hermetic else 0, wait=True,
            command=os.path.join(workdir, "control", "cmd.json")))
    spec = JobSpec(name=name, model=model, global_batch_size=8,
                   steps_per_epoch=steps_per_epoch,
                   config=JobConfig(epochs=epochs),
                   extra={"script": os.path.join(workdir, "probe.py")})
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)

    runs, bad = {}, []
    for tag, coordinator, stop, start in (("a", True, True, 0),
                                          ("b", False, True, None),
                                          ("c", True, False, None)):
        if start is None:  # where the previous run stopped
            prev = runs[chr(ord(tag) - 1)]
            start = prev["checkpoint"][0] if prev["checkpoint"] else -1
        t0 = time.monotonic()
        proc = _dist_supervisor(workdir, tag, coordinator, hermetic)
        acks = None
        if tag == "a":
            # The in-place arm on the rank, in its first epoch: a resize to
            # its size is acked in place, one beyond its card nacked. The
            # rank's channel exists before its "distributed" line; its
            # first step waits for the first command.
            _wait(proc, workdir, tag,
                  lambda: "distributed rank 0 of 1" in _text(
                      workdir, f"{tag}.out"), "its process group",
                  timeout=300.0)
            seqs = [request_resize(workdir, 1)]
            _wait(proc, workdir, tag,
                  lambda: read_resize_ack(workdir, seqs[0]) is not None,
                  "the ack of a resize to 1", timeout=300.0)
            acks = [read_resize_ack(workdir, seqs[0])]
            seqs.append(request_resize(workdir, 2))
        if stop:
            # After its epoch's line: the signal lands during the epoch
            # save's host copy, and the ranks stop at the next epoch's
            # start.
            _wait(proc, workdir, tag,
                  lambda: re.search(r"^epoch \d+ loss", _text(
                      workdir, f"{tag}.out"), re.M) is not None,
                  "its epoch", timeout=300.0)
            proc.send_signal(signal.SIGTERM)
        rc = _finish(proc, workdir, tag)
        wall_s = time.monotonic() - t0
        run = parse_dist_run(_text(workdir, f"{tag}.out"))
        runs[tag] = run
        if acks is not None:
            acks.append(read_resize_ack(workdir, seqs[1]))
            log(f"dist[{tag}] resize acks {json.dumps(acks)}")
        faults = ([] if acks is None else
                  dist_resize_faults(acks)) + dist_run_faults(
            run, rc, plain, coordinator, start, 3 if stop else 0,
            # llama_tiny's loss on random tokens starts near its floor
            # and does not fall in 6 steps; llama_350m's does
            falling=tag == "a" and not hermetic,
            backend="gloo" if hermetic else "nccl",
            launches={} if hermetic else DIST_LAUNCHES)
        log(f"dist[{tag}] {'rank (NCCL)' if coordinator else 'one-card'} "
            f"exit={rc} wall_s={wall_s:.1f} backend={run['backend']} "
            f"plan={run['plan']} params={run['params']} "
            f"dtensor={run['dtensor']} meshes={run['meshes']} "
            f"resumed={run['resumed']} restore_s={run['restore_s']} "
            f"checkpoint={run['checkpoint']} "
            f"launches={_dist_launches(run)} "
            f"losses={run['losses']}")
        if faults:
            bad.append(f"run {tag}: " + "; ".join(faults) + "\n"
                       + _text(workdir, f"{tag}.err")[-3000:])
            break
    if not bad and runs["c"]["losses"] and max(runs["c"]["losses"]) != \
            total - 1:
        bad.append(f"run c ended at step {max(runs['c']['losses'])}")
    if bad:
        raise SystemExit("dist: " + "\n".join(bad))

    rows = read_epoch_csv(os.path.join(workdir, "metrics", f"{name}.csv"))
    by_run = {"a": [], "b": [], "c": []}
    bounds = {"a": runs["b"]["resumed"], "b": runs["c"]["resumed"]}
    for r in rows:
        first = int(r["epoch"]) * steps_per_epoch
        tag = "a" if first < bounds["a"] else "b" if first < bounds["b"] \
            else "c"
        by_run[tag].append(1e3 * float(r["step_time_sec"]))
    log(f"dist step_ms (CSV rows, timed steps of each epoch) rank_a="
        f"{[round(x, 3) for x in by_run['a']]} one_card_b="
        f"{[round(x, 3) for x in by_run['b']]} rank_c="
        f"{[round(x, 3) for x in by_run['c']]} plain_session="
        f"{statistics.median(plain_ms[1:]):.3f} card={card}")
    rank_ms = statistics.median(by_run["a"] + by_run["c"])
    one_ms = statistics.median(by_run["b"])
    log(f"dist rank_step_ms={rank_ms:.3f} one_card_step_ms={one_ms:.3f} "
        f"rank_over_one_card={rank_ms / one_ms:.4f} "
        f"save_a={runs['a']['checkpoint']} save_b={runs['b']['checkpoint']} "
        f"restore_b_s={runs['b']['restore_s']} "
        f"restore_c_s={runs['c']['restore_s']} card={card}")
    shutil.rmtree(workdir)


# mixtral_small through the same rendezvous (phase 12's MoE run): one
# epoch of DIST_MOE_STEPS steps on one NCCL rank, which runs the
# expert-parallel form of the gather dispatch (the routing's all-gather and
# the experts' sums on the rank's groups of one), a sharded save at its end;
# every step's loss within DIST_LOSS_REL of the plain session's, falling.
# Then the one-card path resumes that checkpoint in this process and its
# next step is held to the plain session's.
DIST_MOE_STEPS = 4
DIST_MOE_LAUNCHES = {"flash_fwd": 24, "flash_dq": 12, "flash_dkv": 12}


def run_distributed_moe(card: str, hermetic: bool = False) -> None:
    """Phase 12's MoE run (above). `hermetic` rehearses it on the CPU:
    mixtral_tiny on one CPU device, gloo, no kernel."""
    from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        read_epoch_csv,
    )
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession

    model = "mixtral_tiny" if hermetic else "mixtral_small"
    device = "cpu" if hermetic else None
    steps = DIST_MOE_STEPS
    session = TrainSession(get_model(model), 1, global_batch_size=8,
                           device=device)
    plain, plain_ms = [], []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        plain.append(session.train_step(session.make_batch()).item())
        if not hermetic:
            torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t0))
    del session
    gc.collect()
    if not hermetic:
        torch.cuda.empty_cache()
    one_card_ms = statistics.median(plain_ms[1:])
    log(f"dist_moe plain session losses={[round(x, 6) for x in plain]} "
        f"step_ms={one_card_ms:.3f} (median of steps 2-{steps + 1}) "
        f"card={card}")

    workdir = os.path.join(REPO, "build", "chip_smoke_dist_moe"
                           + ("_hermetic" if hermetic else ""))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    name = f"{model}_dist"
    with open(os.path.join(workdir, "probe.py"), "w") as f:
        f.write(DIST_PROBE.format(delay=0, wait=False, command=""))
    spec = JobSpec(name=name, model=model, global_batch_size=8,
                   steps_per_epoch=steps, config=JobConfig(epochs=1),
                   extra={"script": os.path.join(workdir, "probe.py")})
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)
    t0 = time.monotonic()
    proc = _dist_supervisor(workdir, "moe", True, hermetic)
    rc = _finish(proc, workdir, "moe")
    wall_s = time.monotonic() - t0
    run = parse_dist_run(_text(workdir, "moe.out"))
    # mixtral_tiny's loss on random tokens starts near its floor, as
    # llama_tiny's does (run_distributed)
    bad = dist_run_faults(run, rc, plain, True, 0, 0, falling=not hermetic,
                          backend="gloo" if hermetic else "nccl",
                          launches={} if hermetic else DIST_MOE_LAUNCHES)
    if run["checkpoint"] is None or run["checkpoint"][0] != steps:
        bad.append(f"checkpoint {run['checkpoint']}, want step {steps}")
    log(f"dist_moe rank exit={rc} wall_s={wall_s:.1f} "
        f"backend={run['backend']} plan={run['plan']} "
        f"params={run['params']} dtensor={run['dtensor']} "
        f"checkpoint={run['checkpoint']} launches={_dist_launches(run)} "
        f"losses={run['losses']}")
    if bad:
        raise SystemExit("dist_moe: " + "; ".join(bad) + "\n"
                         + _text(workdir, "moe.err")[-3000:])

    t0 = time.perf_counter()
    resumed = TrainSession.resume(get_model(model), 1,
                                  os.path.join(workdir, "ckpt"),
                                  global_batch_size=8, device=device)
    restore_s = time.perf_counter() - t0
    if resumed.step != steps or torch.distributed.is_initialized():
        raise SystemExit(f"dist_moe: the one-card path resumed at step "
                         f"{resumed.step}, want {steps}")
    loss = resumed.train_step(resumed.make_batch()).item()
    del resumed
    gc.collect()
    if not hermetic:
        torch.cuda.empty_cache()
    gap = abs(loss - plain[steps]) / abs(plain[steps])
    rows = read_epoch_csv(os.path.join(workdir, "metrics", f"{name}.csv"))
    rank_ms = 1e3 * float(rows[0]["step_time_sec"]) if rows else math.nan
    log(f"dist_moe rank_step_ms={rank_ms:.3f} (CSV row, the epoch's timed "
        f"steps) one_card_step_ms={one_card_ms:.3f} rank_over_one_card="
        f"{rank_ms / one_card_ms:.4f} launches={_dist_launches(run)} "
        f"save={run['checkpoint']} restore_one_card_s={restore_s:.3f} "
        f"step {steps} loss one_card_resumed={loss:.9g} "
        f"plain={plain[steps]:.9g} rel_gap={gap:.3g} card={card}")
    if not (math.isfinite(loss) and gap <= DIST_LOSS_REL):
        raise SystemExit(f"dist_moe: the resumed step {steps} loss {loss} "
                         f"against {plain[steps]}")
    shutil.rmtree(workdir)


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
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    start = last = time.perf_counter()

    def phase(name):
        nonlocal last
        now = time.perf_counter()
        log(f"phase {name} took {now - last:.1f} s ({now - start:.1f} s "
            "in all)")
        last = now

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
    if spill_faults(spills, SPILL_GATES):
        raise SystemExit("ptxas spill check failed: "
                         + "; ".join(spill_faults(spills, SPILL_GATES)))

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
             "ragged_q_offset": (2, 4, 320, 1344, 64, True, 1024),
             # head widths above 128: the wide kernels, at llama_350m's
             # width in 4 heads of 256 and in 2 heads of 512
             "d256": (8, 4, 2048, 2048, 256, True, 0),
             "d512": (8, 2, 2048, 2048, 512, True, 0),
             # a ragged wide case, a query slice behind an offset, and the
             # width whose chunk is 128
             "d256_ragged": (2, 4, 1000, 1000, 256, True, 0),
             "d256_q_offset": (2, 4, 512, 2048, 256, True, 1536),
             "d384": (4, 2, 2048, 2048, 384, True, 0)}
    errs = check_kernels(fa, cases)
    rows = time_kernels(fa, main_shape, errs)
    for name in ("d16", "d96"):
        time_padded(fa, name, cases[name])
    rows.update(time_kernels(fa, cases["d256"], errs["d256"], "_wide"))
    time_kernels(fa, cases["d512"], errs["d512"], "_wide")
    time_kernels(fa, cases["d384"], errs["d384"], "_wide")
    torch.cuda.empty_cache()
    # the fp32 and fp16 kernels, at the main shape and the edges
    simt_cases = {name: cases[name] for name in (
        "main", "ragged_noncausal", "d128", "d16", "ragged_q_offset")}
    simt_cases["d256"] = (2, 4, 1024, 1024, 256, True, 0)
    for dtype, suffix in ((torch.float32, "_f32"), (torch.float16, "_f16")):
        simt_errs = check_kernels(fa, simt_cases, dtype, SIMT_LIMITS[dtype],
                                  twice=dtype == torch.float32)
        rows.update(time_kernels(fa, main_shape, simt_errs, suffix, dtype))
        torch.cuda.empty_cache()
    # fp32's forward, dQ and dK/dV on the CUDA cores (`_f32_simt`, which no
    # route takes), held to fp32's bars at the main shape and timed in turns
    # with the TF32 kernels that replaced them there
    f32 = torch.float32
    with routed(fa, CUDA_CORE_F32):
        check_kernels(fa, {"main": main_shape}, f32, SIMT_LIMITS[f32])
    turns64 = time_turns(fa, main_shape, f32, CUDA_CORE_F32)
    for new in CUDA_CORE_F32:
        rows[new]["ms"] = turns64[new]
    # fp32 above D=128: the TF32 kernels that stream D (`_f32_wide`) at
    # F32_WIDE_CASES, K1, K2 and K3 launched twice and held bitwise; timed at
    # d256 beside the plain versions, SDPA's fp32 forward and the library's
    # fp32 backward, and in turns there against the CUDA-core kernels they
    # took the route from, held at d256 too; those rows carry the wide
    # rows' plain and library times (the same function on the same inputs)
    # and their errors at d256
    f32_wide_errs = check_kernels(fa, F32_WIDE_CASES, f32, SIMT_LIMITS[f32],
                                  twice=True)
    f32_d256 = time_kernels(fa, cases["d256"], f32_wide_errs, "_f32_wide",
                            f32)
    with routed(fa, CUDA_CORE_F32_WIDE):
        simt_d256 = check_kernels(fa, {"d256": simt_cases["d256"]}, f32,
                                  SIMT_LIMITS[f32])
    turns = time_turns(fa, cases["d256"], f32, CUDA_CORE_F32_WIDE)
    for new, old in CUDA_CORE_F32_WIDE.items():
        rows[new] = {**f32_d256[new], "ms": turns[new]}
        rows[old] = {**f32_d256[new], "ms": turns[old],
                     "err": (max(simt_d256["o"], simt_d256["lse"])
                             if "fwd" in new else simt_d256["dq_abs"]
                             if "dq" in new else
                             max(simt_d256["dk_abs"], simt_d256["dv_abs"])),
                     "source": ("vodascheduler_tpu_torch/ops/csrc/"
                                f"{fa.source(old)}.cu")}
        b = rows[new]["b"][0]
        log(f"time[f32 wide] D=256 B=8 H=4 S=2048 {new} "
            f"ms={turns[new]:.4f} roofline_share={b / turns[new]:.3f} "
            f"bound_ms={b:.4f} plain_ms={rows[new]['plain_ms']:.4f} "
            f"library_ms={rows[new]['library_ms']:.4f} "
            f"library_over_kernel={rows[new]['library_ms'] / turns[new]:.3f} "
            f"{old} ms={turns[old]:.4f} "
            f"cuda_cores_over_tensor_cores={turns[old] / turns[new]:.3f} "
            f"card={card}")
    backward_turns("backward_f32_wide", 256, turns, CUDA_CORE_F32_WIDE,
                   rows["flash_dkv_f32_wide"]["library_ms"], card)
    backward_turns("backward_f32", 64, turns64, CUDA_CORE_F32,
                   rows["flash_dkv_f32"]["library_ms"], card)
    torch.cuda.empty_cache()
    # fp16's wide forward, dQ and dK/dV (wgmma) at the wide bf16 kernels'
    # shapes and non-causal, timed at d256; the CUDA-core ones at D=640,
    # which only they take
    f16 = torch.float16
    wide_cases = {name: cases[name] for name in (
        "d256", "d512", "d384", "d256_ragged", "d256_q_offset")}
    wide_cases["d256_noncausal"] = (2, 4, 1000, 1000, 256, False, 0)
    wide_errs = check_kernels(fa, wide_cases, f16, SIMT_LIMITS[f16])
    d256_rows = time_kernels(fa, cases["d256"], wide_errs, "_f16_wide", f16)
    f16_wide = [n for n in CUDA_CORE_F16 if n.endswith("_wide")]
    for name in f16_wide:
        rows[name] = d256_rows[name]
    # fp16's K1, K2 and K3 on the CUDA cores (`_f16_simt`), held to the same
    # bars at the main shape and timed in turns with the tensor-core
    # kernels that replaced them there and at d256; their rows from d256
    # (phase 11's fp16 model in heads of 256) carry the plain and library
    # times of the wide tensor-core rows (the same function on the same
    # inputs), until the rows at D=640 take their place below
    with routed(fa, CUDA_CORE_F16):
        check_kernels(fa, {"main": main_shape}, f16, SIMT_LIMITS[f16])
    for shape in (main_shape, cases["d256"]):
        turns = time_turns(fa, shape)
        for new in turns:
            if new in rows:
                rows[new]["ms"] = turns[new]
    for new in f16_wide:
        old = CUDA_CORE_F16[new]
        rows[old] = {**rows[new], "ms": turns[old], "source": (
            f"vodascheduler_tpu_torch/ops/csrc/{fa.source(old)}.cu")}
        log(f"time[f16 wide] D=256 {new} ms={rows[new]['ms']:.4f} "
            f"roofline_share={rows[new]['b'][0] / rows[new]['ms']:.3f} "
            f"library_ms={rows[new]['library_ms']:.4f} {old} "
            f"ms={turns[old]:.4f} cuda_cores_over_tensor_cores="
            f"{turns[old] / rows[new]['ms']:.3f}")
    torch.cuda.empty_cache()
    # K1 above D=512 in bf16 and fp16 (flash_fwd_chunked_kernel), and the
    # kernel fp16's took the route from there (flash_fwd_f16_simt's row, at
    # D=640, takes the place of its d256 one); K2 and K3 above D=512 in bf16
    # and fp16 (flash_dq_chunked_kernel, flash_dkv_chunked_kernel) and the
    # CUDA-core pair fp16's took the route from (whose rows, at D=640, take
    # the place of the d256 ones)
    rows.update(run_chunked(fa))
    rows.update(run_chunked_backward(fa))
    phase("3 kernels")

    counts = run_slice(fa)[0]
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
    phase("4-5d slices and the job")
    run_benches()
    gc.collect()
    torch.cuda.empty_cache()
    phase("5e hwbench")
    log(f"sched launches (three supervisors, summed) {run_scheduler()}")
    phase("6 scheduler")
    log(f"server launches (three supervisors, summed) {run_server()}")
    phase("7 server")
    run_example_jobs()
    phase("8 example jobs")
    counts.update({k: v for k, v in run_families(fa).items()
                   if k.endswith("_wide")})
    phase("9 families")
    gc.collect()
    torch.cuda.empty_cache()
    run_resize(smi.stdout.strip().splitlines()[0])
    phase("10 resize")
    counts.update(run_dtype_slices(fa))
    phase("11 fp32 and fp16")
    gc.collect()
    torch.cuda.empty_cache()
    run_distributed(card)
    gc.collect()
    torch.cuda.empty_cache()
    run_distributed_moe(card)
    phase("12 one job on a process group")

    # every row's launches from a counted step: K1 above D=512 and the
    # kernels it replaced there (no model runs that width) read 0 there
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
