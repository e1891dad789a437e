"""Where `TrainSession` installs the flash-attention kernels, decided on the
CPU (a ``torch.device("cuda")`` object needs no card).

The JAX kernels compute in ``q.dtype``, and so do the port's: bf16 tensors
take the wgmma kernels, fp32 tensors the TF32 forward, dQ and dK/dV up to
a head width of 128 (``csrc/flash_f32.cu``: ``flash_fwd_f32``,
``flash_dq_f32``, ``flash_dkv_f32``) and the TF32 ones that stream D above
it (``_f32_wide``, the same source),
fp16 tensors the wgmma forward, dQ and dK/dV up
to a head width of 128 (``flash_fwd_f16``, ``flash_dq_f16``,
``flash_dkv_f16``) and above it (``_f16_wide``; above 512, in both types,
the kernels of the same sources that stream D, counted as ``_chunked`` and
``_f16_chunked``). So a Llama
or Mixtral takes the kernels on CUDA whatever dtype it computes in, and no path gives way to the
plain attention on the card. ``VODA_FLASH_ATTENTION`` forces the plain
attention (0) or the kernels (1, which raises off CUDA). The card tests of
the same choice are
`test_torch_cuda.py::test_fp32_and_fp16_llamas_train_through_their_kernels`.
"""

import dataclasses
import functools
import re
import types

import pytest
import torch

from vodascheduler_tpu_torch.models import llama
from vodascheduler_tpu_torch.models.registry import llama_bundle
from vodascheduler_tpu_torch.ops import _build
from vodascheduler_tpu_torch.ops import flash_attention as fa
from vodascheduler_tpu_torch.runtime import train

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_flag(monkeypatch):
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)


@pytest.mark.parametrize("flag,device,want", [
    ("auto", CUDA, True), ("auto", CPU, False),
    ("0", CUDA, False), ("0", CPU, False),
    ("1", CUDA, True),
])
def test_the_flag_and_the_device(flag, device, want, monkeypatch):
    monkeypatch.setenv("VODA_FLASH_ATTENTION", flag)
    assert train._flash_attention_enabled(device) is want


def test_forcing_the_kernels_off_cuda_raises(monkeypatch):
    monkeypatch.setenv("VODA_FLASH_ATTENTION", "1")
    with pytest.raises(RuntimeError, match="cpu"):
        train._flash_attention_enabled(CPU)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_every_compute_dtype_takes_the_kernels(dtype, monkeypatch):
    """With the kernels enabled (as on CUDA), the session installs them in
    a Llama of any compute dtype: the operator picks that dtype's kernel."""
    monkeypatch.setattr(train, "_flash_attention_enabled", lambda d: True)
    bundle = llama_bundle(f"llama_tiny_{dtype}", dataclasses.replace(
        llama.LLAMA_TINY, dtype=dtype), 64)
    session = train.TrainSession(bundle, global_batch_size=2, device="cpu")
    fn = session.module.attn_fn
    assert isinstance(fn, functools.partial) and fn.func is fa.flash_attention
    assert fn.keywords == {"causal": True}


@pytest.mark.parametrize("dtype,suffix", [
    (torch.bfloat16, ""), (torch.float32, "_f32"), (torch.float16, "_f16")])
def test_each_dtype_has_its_kernels(dtype, suffix):
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        kernel = fa._kernel(name, fa.kernel_head_dim(16), dtype)
        assert kernel == name + suffix
        assert kernel in fa.launches and kernel in fa._ARGTYPES
        # fp32's are the TF32 ones; fp16's sit in the bf16 kernels' sources
        if dtype == torch.float32:
            assert fa.source(kernel) == fa.TF32_SOURCE
        else:
            assert fa.source(kernel) == name


@pytest.mark.parametrize("D", [256, 384, 512])
def test_fp16_heads_above_128_take_the_wide_wgmma_forward_and_dkv(D):
    """The wide bf16 kernels' sources, templated on fp16, take fp16's
    forward, dQ and dK/dV from 256 to 512."""
    want = {"flash_fwd": ("flash_fwd_f16_wide", "flash_fwd_wide"),
            "flash_dq": ("flash_dq_f16_wide", "flash_dq_wide"),
            "flash_dkv": ("flash_dkv_f16_wide", "flash_dkv_wide")}
    for name, (kernel, src) in want.items():
        assert fa._kernel(name, fa.kernel_head_dim(D), torch.float16) \
            == kernel
        assert fa.source(kernel) == src
        assert kernel in fa.launches and kernel in fa._ARGTYPES


@pytest.mark.parametrize("D", [640, 1024])
def test_fp16_heads_above_512_take_the_chunked_kernels(D):
    """Above 512 fp16's forward, dQ and dK/dV take the wide entries, whose
    kernels there stream D (flash_{fwd,dq,dkv}_wide.cu's chunked kernels),
    counted apart as `_f16_chunked`; no route reaches the CUDA-core
    `_f16_simt` kernels, which keep entries only to be timed. bf16's take
    the same chunked kernels through its wide entries, counted as
    `_chunked`; its wmma kernels are gone."""
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        kernel = fa._kernel(name, fa.kernel_head_dim(D), torch.float16)
        assert kernel == f"{name}_f16_wide"
        assert fa.source(kernel) == f"{name}_wide"
        assert kernel in fa.launches and kernel in fa._ARGTYPES
        count = fa.counted(kernel, D)
        assert count == f"{name}_f16_chunked" and count in fa.launches
        assert fa.source(count) == f"{name}_wide"
        assert fa._kernel(name, D, torch.bfloat16) == f"{name}_wide"
        assert fa.counted(f"{name}_wide", D) == f"{name}_chunked"
        assert f"{name}_chunked" in fa.launches
        assert fa.source(f"{name}_chunked") == f"{name}_wide"
    assert not any("wmma" in k for k in fa.launches)
    # the kernels that lost their routes keep entries of their own, to be
    # timed against their replacements
    for old, src in (("flash_fwd_f16_simt", fa.SIMT_SOURCE),
                     ("flash_dq_f16_simt", fa.SIMT_SOURCE),
                     ("flash_dkv_f16_simt", fa.SIMT_SOURCE)):
        assert old in fa.launches and fa.source(old) == src
        assert fa._ARGTYPES[old] == fa._ARGTYPES["_".join(
            old.split("_")[:2])]
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            assert not fa._kernel(name, D, dtype).endswith("_f16_simt")


@pytest.mark.parametrize("D", [16, 64, 96, 128, 256, 384, 640, 1024])
def test_fp32_takes_the_tf32_forward_and_dkv_at_every_width(D, monkeypatch):
    """fp32's forward, dQ and dK/dV run on the tensor cores in three TF32
    passes at every width (flash_f32.cu): `_f32` up to a head width of 128,
    `_f32_wide` above it, each counted apart. Both forwards take their
    scratch after lse, both dQ entries after dq and both dK/dV entries
    after dv, one pointer more than the CUDA-core kernels, and the wrapper
    passes it."""
    width = fa.kernel_head_dim(D)
    suffix = "_f32" if width in fa.HEAD_DIMS else "_f32_wide"
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        kernel = fa._kernel(name, width, torch.float32)
        assert kernel == name + suffix
        assert fa.source(kernel) == fa.TF32_SOURCE
        assert kernel in fa.TF32_KERNELS and kernel not in fa.SIMT_KERNELS
        assert kernel in fa.launches and kernel in fa._ARGTYPES
        assert fa.counted(kernel, width) == kernel
    fwd, dq, dkv = ("flash_fwd" + suffix, "flash_dq" + suffix,
                    "flash_dkv" + suffix)
    for kernel in (fwd, dq, dkv):
        assert kernel in fa.F32_SCRATCH
        assert len(fa._ARGTYPES[kernel]) == len(fa._ARGTYPES[
            kernel.replace(suffix, "_f32_simt")]) + 1
    launched = []
    monkeypatch.setattr(fa, "_launch", lambda name, device, *args, count:
                        launched.append((name, count, len(args))))
    q = torch.zeros(1, 3, 1, width, dtype=torch.float32)
    fa.flash_fwd(q, q, q, True, 0)
    fa.flash_dq(q, q, q, q, q, torch.zeros(1, 1, 3), True, 0)
    fa.flash_dkv(q, q, q, q, torch.zeros(1, 1, 3), torch.zeros(1, 1, 3),
                 True, 0)
    # the stream is the one argument _launch adds
    assert launched == [(k, k, len(fa._ARGTYPES[k]) - 1)
                        for k in (fwd, dq, dkv)]
    assert "flash_dq_f32" not in fa.SIMT_KERNELS


def test_the_tf32_forward_scratch_holds_the_split_k_and_vt():
    """K_hi, K_lo ([B, Sk, H, D]) and Vᵀ_hi, Vᵀ_lo ([B, H, D, SkP], SkP =
    Sk rounded up to 8), as flash_f32.cu's SplitKV slices it for the
    forward at every width."""
    for B, H, Sk, D in ((2, 3, 200, 64), (1, 1, 8, 128), (1, 2, 1, 64),
                        (2, 1, 333, 256), (1, 2, 65, 640)):
        skp = -(-Sk // 8) * 8
        t = fa.f32_scratch(B, H, Sk, D, CPU)
        assert t.dtype == torch.float32
        assert t.numel() == 2 * B * Sk * H * D + 2 * B * H * D * skp
    text = (_build.CSRC / "flash_f32.cu").read_text()
    assert "2·B·H·D·(Sk + SkP) floats" in text


def test_the_tf32_dq_scratch_holds_the_split_k_v_and_kt():
    """K_hi, K_lo, V_hi, V_lo ([B, Sk, H, D]) and Kᵀ_hi, Kᵀ_lo ([B, H, D,
    SkP]), as flash_f32.cu's SplitDq slices it for dQ at every width: six
    times K's floats, and Kᵀ's padded keys beside."""
    for B, H, Sk, D in ((2, 3, 200, 64), (1, 1, 8, 128), (1, 2, 1, 64),
                        (2, 1, 333, 256), (1, 2, 65, 640)):
        skp = -(-Sk // 8) * 8
        t = fa.f32_scratch(B, H, Sk, D, CPU, "flash_dq")
        assert t.dtype == torch.float32
        assert t.numel() == 4 * B * Sk * H * D + 2 * B * H * D * skp
    text = (_build.CSRC / "flash_f32.cu").read_text()
    assert "2·B·H·D·(2·Sk + SkP) floats" in text


def test_the_tf32_dkv_scratch_holds_every_operands_halves():
    """Q_hi, Q_lo, dO_hi, dO_lo ([B, Sq, H, D]), K_hi, K_lo, V_hi, V_lo ([B,
    Sk, H, D]) and Qᵀ_hi, Qᵀ_lo, dOᵀ_hi, dOᵀ_lo ([B, H, D, SqP], SqP = Sq
    rounded up to 8), as flash_f32.cu's SplitDkv slices it for dK/dV at
    every width."""
    for B, H, Sq, Sk, D in ((2, 3, 200, 200, 64), (1, 1, 8, 24, 128),
                            (1, 2, 1, 64, 64), (2, 1, 65, 333, 256),
                            (1, 2, 65, 65, 640)):
        sqp = -(-Sq // 8) * 8
        t = fa.f32_scratch(B, H, Sk, D, CPU, "flash_dkv", Sq)
        assert t.dtype == torch.float32
        assert t.numel() == (4 * B * Sq * H * D + 4 * B * Sk * H * D
                             + 4 * B * H * D * sqp)
    text = (_build.CSRC / "flash_f32.cu").read_text()
    assert "4·B·H·D·(Sq + Sk + SqP) floats" in text


@pytest.mark.parametrize("source,exports,lacks", [
    ("flash_fwd_wide", ("voda_flash_fwd_wide", "voda_flash_fwd_f16_wide"),
     ("voda_flash_fwd_wmma",)),
    ("flash_dkv_wide", ("voda_flash_dkv_wide", "voda_flash_dkv_f16_wide"),
     ()),
    ("flash_simt", ("voda_flash_fwd_f32_simt", "voda_flash_dq_f32_simt",
                    "voda_flash_dkv_f32_simt", "voda_flash_dq_f16_simt",
                    "voda_flash_fwd_f16_simt", "voda_flash_dkv_f16_simt"),
     ("voda_flash_fwd_f16_wide", "voda_flash_dkv_f16_wide",
      "voda_flash_dq_f16", "voda_flash_dq_f16_wide", "voda_flash_fwd_f32",
      "voda_flash_dq_f32", "voda_flash_dkv_f32", "voda_flash_fwd_f32_wide",
      "voda_flash_dq_f32_wide", "voda_flash_dkv_f32_wide")),
    ("flash_dq", ("voda_flash_dq", "voda_flash_dq_f16"),
     ("voda_flash_dq_f16_simt",)),
    ("flash_dq_wide", ("voda_flash_dq_wide", "voda_flash_dq_f16_wide"),
     ("voda_flash_dq_f16",)),
    ("flash_f32", ("voda_flash_fwd_f32", "voda_flash_dq_f32",
                   "voda_flash_dkv_f32", "voda_flash_fwd_f32_wide",
                   "voda_flash_dq_f32_wide", "voda_flash_dkv_f32_wide"),
     ("voda_flash_fwd_f32_simt", "voda_flash_dq_f32_simt",
      "voda_flash_dkv_f32_simt")),
])
def test_each_source_exports_the_entries_its_kernels_are_named_by(
        source, exports, lacks):
    """The C entry points, read from the sources' text (no nvcc here): the
    dQ sources and the wide ones export fp16's `_f16` and `_f16_wide`
    entries beside bf16's, flash_simt.cu exports the renamed `_f16_simt`
    and `_f32_simt` ones and no other entry, and flash_f32.cu fp32's
    forward, dQ and dK/dV alone, at both widths (`_f32`, `_f32_wide`). Each
    name the wrappers route to a source is an entry of it."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    entries = set(re.findall(r'extern "C" int (voda_\w+)\(', text))
    for sfx in re.findall(r"VODA_SIMT_ENTRIES\(\w+, (\w+)\)", text):
        entries |= {f"voda_flash_{n}_{sfx}" for n in ("fwd", "dq", "dkv")}
    assert set(exports) <= entries
    assert not set(lacks) & entries
    routed = {f"voda_{fa.entry(k)}" for k in fa.launches
              if fa.source(k) == source}
    assert routed <= entries


@pytest.mark.parametrize("names", [
    ("flash_fwd", "flash_dq", "flash_dkv"),
    ("flash_fwd_wide", "flash_dq_wide", "flash_dkv_wide"),
    ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32"),
    ("flash_fwd_f32_wide", "flash_dq_f32_wide", "flash_dkv_f32_wide"),
    (),
    ("flash_fwd_f16", "flash_dq_f16", "flash_dkv_f16"),
    ("flash_fwd_f16_wide", "flash_dq_f16_wide", "flash_dkv_f16_wide"),
    ("flash_fwd_f16_simt", "flash_dq_f16_simt", "flash_dkv_f16_simt"),
    ("flash_fwd_f32_simt", "flash_dq_f32_simt", "flash_dkv_f32_simt")])
def test_load_kernels_loads_the_named_kernels(names, monkeypatch):
    """What the resize bench's restart child loads before the session: the
    kernels the prepare child's steps launched, and no other."""
    loaded = []
    monkeypatch.setattr(fa, "_entry", loaded.append)
    fa.load_kernels(names)
    assert tuple(loaded) == names


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "flash_fwd_wide"), (torch.float16, "flash_fwd_f16_wide"),
    (torch.float16, "flash_dq_f16_wide"), (torch.float16, "flash_dkv_f16_wide"),
    (torch.bfloat16, "flash_dq_wide"), (torch.bfloat16, "flash_dkv_wide")])
@pytest.mark.parametrize("D", [256, 512, 640, 1024])
def test_the_chunked_forward_counts_apart_from_its_route(dtype, route, D,
                                                         monkeypatch):
    """Above WGMMA_MAX_D the wide entries of the forward, dQ and dK/dV, in
    bf16 and fp16, launch the kernel of their source that streams D: the
    wrapper launches the route's entry and raises the chunked kernel's own
    count (`CHUNKED_COUNTS`), so that the route's D ≤ 512 kernel and the
    chunked one are counted apart; a count's name loads its route's entry
    from the route's source."""
    launched = []
    monkeypatch.setattr(fa, "_launch", lambda name, device, *args, count:
                        launched.append((name, count)))
    q = torch.zeros(1, 3, 1, D, dtype=dtype)
    stat = torch.zeros(1, 1, 3)
    fn = route.split("_")[1]
    if fn == "fwd":
        fa.flash_fwd(q, q, q, True, 0)
    elif fn == "dq":
        fa.flash_dq(q, q, q, q, q, stat, True, 0)
    else:
        fa.flash_dkv(q, q, q, q, stat, stat, True, 0)
    chunked = fa.CHUNKED_COUNTS[route]
    assert launched == [(route, chunked if D > fa.WGMMA_MAX_D else route)]
    assert chunked in fa.launches and chunked not in fa._ARGTYPES
    assert fa.entry(chunked) == route and fa.entry(route) == route
    assert fa.source(chunked) == fa.source(route) == f"flash_{fn}_wide"
    loaded, lib = [], types.SimpleNamespace(**{
        f"voda_{route}": types.SimpleNamespace()})
    monkeypatch.setattr(fa._build, "load",
                        lambda src: loaded.append(src) or lib)
    monkeypatch.setattr(fa, "_entry", fa._entry.__wrapped__)
    fa.load_kernels([chunked])
    assert loaded == [f"flash_{fn}_wide"]
    assert getattr(lib, f"voda_{route}").argtypes == fa._ARGTYPES[route]


def test_each_entry_takes_the_arguments_its_wrapper_passes():
    """Every kernel defined by an explicit ``extern "C"`` entry takes as
    many arguments as its `_ARGTYPES` row passes (the stream among them):
    ctypes would pass a short row's last arguments as garbage."""
    checked = set()
    for source in _build.SOURCES:
        text = (_build.CSRC / f"{source}.cu").read_text()
        for name, params in re.findall(
                r'extern "C" int voda_(\w+)\(([^)]*)\)', text):
            assert len(params.split(",")) == len(fa._ARGTYPES[name]), name
            checked.add(name)
    assert {"flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32",
            "flash_fwd_f32_wide", "flash_dq_f32_wide", "flash_dkv_f32_wide",
            "flash_fwd", "flash_dkv_f16_wide"} <= checked
