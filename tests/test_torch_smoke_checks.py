"""The host-side checks of chip_smoke.py, on the CPU: the parse of ptxas's
register report behind its spill gate, and the bounds it reports."""

import os
import re
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# the kernels are templated on their width and element type (bf16 and
# fp16, named `_f16`), as ptxas names them
FWD64 = "_ZN4voda16flash_fwd_kernelILi64E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_PT0_Pfiiiiif"
DKV64 = "_ZN4voda16flash_dkv_kernelILi64E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_S2_PKfS4_PT0_S6_iiiiif"
DKV128 = DKV64.replace("ILi64E", "ILi128E")
FWD64_F16 = FWD64.replace("13__nv_bfloat16", "6__half")
DKV64_F16 = DKV64.replace("13__nv_bfloat16", "6__half")
DKV128_F16 = DKV64_F16.replace("ILi64E", "ILi128E")
DQ64 = "_ZN4voda15flash_dq_kernelILi64E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_S2_S2_PKfPfPT0_iiiiif"
DQ128 = DQ64.replace("ILi64E", "ILi128E")
DQ64_F16 = DQ64.replace("13__nv_bfloat16", "6__half")
DQ128_F16 = DQ64_F16.replace("ILi64E", "ILi128E")
# the wide kernels, templated on their element type as well
FWDW256 = "_ZN4voda21flash_fwd_wide_kernelILi256E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_PT0_Pfiiiiif"
DKVW256 = "_ZN4voda21flash_dkv_wide_kernelILi256E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_S2_PKfS4_PT0_S6_iiiiif"
FWDW256_F16 = FWDW256.replace("13__nv_bfloat16", "6__half")
DKVW256_F16 = DKVW256.replace("13__nv_bfloat16", "6__half")
DKVW512_F16 = DKVW256_F16.replace("ILi256E", "ILi512E")
DQW256 = "_ZN4voda20flash_dq_wide_kernelILi256E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_S2_PKT0_PKfPfPS3_iiiiif"
DQW256_F16 = DQW256.replace("13__nv_bfloat16", "6__half")
DQW512_F16 = DQW256_F16.replace("ILi256E", "ILi512E")
FWDW512 = FWDW256.replace("ILi256E", "ILi512E")
DKVW384 = DKVW256.replace("ILi256E", "ILi384E")
DQW512 = DQW256.replace("ILi256E", "ILi512E")
# fp32's TF32 forward, templated on its width alone
FWD64_F32 = "_ZN4voda3f3220flash_fwd_f32_kernelILi64EEEv14CUtensorMap_stS2_S2_S2_S2_PfS3_iiiiif"
FWD128_F32 = FWD64_F32.replace("ILi64E", "ILi128E")
# fp32's TF32 dK/dV, one kernel at every width, templated on its chunk of
# dK and dV: CW=64 at D=64, CW=128 at D=128 and above
DKV64_F32 = "_ZN4voda3f3220flash_dkv_f32_kernelILi64EEEv14CUtensorMap_stS2_S2_S2_S2_S2_S2_S2_S2_S2_S2_S2_PKfS4_PfS5_iiiiiif"
DKV128_F32 = DKV64_F32.replace("ILi64E", "ILi128E")
# the forward above D=512, templated on its chunk of O (CW) and element
# type: D=640 runs CW=128
FWDC128 = "_ZN4voda24flash_fwd_chunked_kernelILi128E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_PT0_Pfiiiiiif"
FWDC128_F16 = FWDC128.replace("13__nv_bfloat16", "6__half")
FWDC256 = FWDC128.replace("ILi128E", "ILi256E")
# dQ and dK/dV above D=512, templated the same way, in bf16 and fp16
DQC128 = "_ZN4voda23flash_dq_chunked_kernelILi128E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_S2_PKT0_S5_PKfPfPS3_iiiiiif"
DKVC128 = "_ZN4voda24flash_dkv_chunked_kernelILi128E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_S2_PKfS4_PT0_S6_iiiiiif"
DQC256 = DQC128.replace("ILi128E", "ILi256E")
DKVC256 = DKVC128.replace("ILi128E", "ILi256E")
DQC128_F16 = DQC128.replace("13__nv_bfloat16", "6__half")
DKVC128_F16 = DKVC128.replace("13__nv_bfloat16", "6__half")
DQC256_F16 = DQC128_F16.replace("ILi128E", "ILi256E")
DKVC256_F16 = DKVC128_F16.replace("ILi128E", "ILi256E")
# fp32's TF32 forward above D=128, templated on its chunk of O alone
# (CW=128 runs every width)
FWDW128_F32 = "_ZN4voda3f3225flash_fwd_f32_wide_kernelILi128EEEv14CUtensorMap_stS2_S2_S2_S2_PfS3_iiiiiif"
# fp32's TF32 dQ, one kernel at every width, templated on its chunk of dQ:
# CW=64 at D=64, CW=128 at D=128 and above
DQ64_F32 = "_ZN4voda3f3219flash_dq_f32_kernelILi64EEEv14CUtensorMap_stS2_S2_S2_S2_S2_S2_S2_PKfS4_S4_PfS5_iiiiiif"
DQ128_F32 = DQ64_F32.replace("ILi64E", "ILi128E")
F16_CLEAN = ((FWD64_F16, 0, 0), (DQ64_F16, 0, 0), (DKV64_F16, 0, 0),
             (FWD64_F32, 0, 0), (DQ64_F32, 0, 0), (DKV64_F32, 0, 0))
MAIN_CLEAN = ((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), *F16_CLEAN)
# (with the chunked forward's, gated beside the wide kernels)
WIDE_F16_CLEAN = ((FWDW256_F16, 0, 0), (DQW256_F16, 0, 0),
                  (DKVW256_F16, 0, 0), (FWDC128, 0, 0), (FWDC128_F16, 0, 0),
                  (DQC128, 0, 0), (DKVC128, 0, 0),
                  (DQC128_F16, 0, 0), (DKVC128_F16, 0, 0),
                  (FWDW128_F32, 0, 0), (DKV128_F32, 0, 0),
                  (DQ128_F32, 0, 0))
WIDE_CLEAN = ((FWDW256, 0, 0), (DQW256, 0, 0), (DKVW256, 0, 0),
              *WIDE_F16_CLEAN)


def untouched(clean, kernels):
    """The entries of `clean` whose kernel `kernels` name at no width."""
    base = lambda name: re.sub(r"ILi\d+E", "", name)
    named = {base(k[0]) for k in kernels}
    return tuple(k for k in clean if base(k[0]) not in named)


def log_of(*kernels):
    """An `nvcc -Xptxas -v` log with one entry per (name, stores, loads)."""
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, st, ld in kernels:
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    0 bytes stack frame, {st} bytes spill stores, {ld} bytes spill loads",
            "ptxas info    : Used 168 registers, used 1 barriers",
        ]
    return "\n".join(lines)


def test_ptxas_spills_reads_every_kernel_and_head_dim():
    spills = chip_smoke.ptxas_spills(log_of((FWD64, 0, 0), (DQ64, 0, 0),
                                            (DKV64, 0, 0), (DKV128, 200, 144),
                                            *F16_CLEAN, (DKV128_F16, 8, 8),
                                            (DKV128_F32, 64, 88)))
    assert spills == {("flash_fwd", 64): 0, ("flash_dq", 64): 0,
                      ("flash_dkv", 64): 0, ("flash_dkv", 128): 344,
                      ("flash_fwd_f16", 64): 0, ("flash_dq_f16", 64): 0,
                      ("flash_dkv_f16", 64): 0, ("flash_dkv_f16", 128): 16,
                      ("flash_fwd_f32", 64): 0, ("flash_dq_f32", 64): 0,
                      ("flash_dkv_f32", 64): 0, ("flash_dkv_f32", 128): 152}
    assert chip_smoke.spill_faults(spills) == []


@pytest.mark.parametrize("kernels,fault", [
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 44, 60)),
     "flash_dkv D=64: 104 bytes spilled"),
    (((FWD64, 8, 0), (DQ64, 0, 0), (DKV64, 0, 0)),
     "flash_fwd D=64: 8 bytes spilled"),
    (((DQ64, 0, 0), (DKV64, 0, 0)), "flash_fwd D=64: no ptxas spill line"),
    (((FWD64, 0, 0), (DQ64, 16, 16), (DKV64, 0, 0)),
     "flash_dq D=64: 32 bytes spilled"),
    (((FWD64, 0, 0), (DQ128, 0, 0), (DKV64, 0, 0)),
     "flash_dq D=64: no ptxas spill line"),
    # fp16's tensor-core kernels, gated as the bf16 ones
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), (FWD64_F16, 4, 4)),
     "flash_fwd_f16 D=64: 8 bytes spilled"),
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), (DKV128_F16, 0, 0)),
     "flash_dkv_f16 D=64: no ptxas spill line"),
    # a bf16 kernel's spill is not read as fp16's, nor fp16's as bf16's
    (((FWD64_F16, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0)),
     "flash_fwd D=64: no ptxas spill line"),
    # fp16's tensor-core dQ, gated as the bf16 one
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), (DQ64_F16, 8, 8)),
     "flash_dq_f16 D=64: 16 bytes spilled"),
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), (DQ128_F16, 0, 0)),
     "flash_dq_f16 D=64: no ptxas spill line"),
    # fp32's TF32 forward and dK/dV, gated as the bf16 ones (dK/dV by its
    # chunk of the output, CW=64 at D=64)
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), (DKV64_F32, 320, 304)),
     "flash_dkv_f32 CW=64: 624 bytes spilled"),
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), (FWD128_F32, 0, 0)),
     "flash_fwd_f32 D=64: no ptxas spill line"),
    # fp32's TF32 dQ at D=64 (CW=64); its CW=128 line does not stand for it
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), (DQ64_F32, 8, 8)),
     "flash_dq_f32 CW=64: 16 bytes spilled"),
    (((FWD64, 0, 0), (DQ64, 0, 0), (DKV64, 0, 0), (DQ128_F32, 0, 0)),
     "flash_dq_f32 CW=64: no ptxas spill line"),
])
def test_spill_faults_refuse_a_spill_or_a_missing_line_at_d64(kernels, fault):
    """Each case's log also holds the fp16 and fp32 tensor-core kernels'
    clean lines, except where the case names such a kernel itself."""
    assert chip_smoke.spill_faults(chip_smoke.ptxas_spills(
        log_of(*kernels, *untouched(F16_CLEAN, kernels)))) == [fault]


def test_spill_at_d128_is_only_logged():
    spills = chip_smoke.ptxas_spills(log_of((FWD64, 0, 0), (DQ64, 0, 0),
                                            (DKV64, 0, 0), (DKV128, 500, 244),
                                            (DQ128, 8, 8), *F16_CLEAN,
                                            (DKV128_F16, 40, 40),
                                            (DKV128_F32, 64, 88)))
    assert chip_smoke.spill_faults(spills) == []


def test_ptxas_spills_reads_the_wide_kernels_by_width():
    spills = chip_smoke.ptxas_spills(log_of(
        *MAIN_CLEAN, *WIDE_CLEAN, (FWDW512, 600, 532), (DKVW384, 0, 0),
        (DQC256, 12, 12), (DKVW512_F16, 16, 16)))
    assert spills == {("flash_fwd", 64): 0, ("flash_dq", 64): 0,
                      ("flash_dkv", 64): 0, ("flash_fwd_f16", 64): 0,
                      ("flash_dq_f16", 64): 0,
                      ("flash_fwd_f32", 64): 0, ("flash_dkv_f32", 64): 0,
                      ("flash_dq_f32", 64): 0, ("flash_dq_f32", 128): 0,
                      ("flash_dkv_f16", 64): 0, ("flash_fwd_wide", 256): 0,
                      ("flash_dq_wide", 256): 0, ("flash_dkv_wide", 256): 0,
                      ("flash_fwd_f16_wide", 256): 0,
                      ("flash_dq_f16_wide", 256): 0,
                      ("flash_dkv_f16_wide", 256): 0,
                      ("flash_fwd_chunked", 128): 0,
                      ("flash_fwd_chunked_f16", 128): 0,
                      ("flash_dq_chunked", 128): 0,
                      ("flash_dkv_chunked", 128): 0,
                      ("flash_dq_chunked", 256): 24,
                      ("flash_dq_chunked_f16", 128): 0,
                      ("flash_dkv_chunked_f16", 128): 0,
                      ("flash_fwd_f32_wide", 128): 0,
                      ("flash_dkv_f32", 128): 0,
                      ("flash_fwd_wide", 512): 1132,
                      ("flash_dkv_wide", 384): 0,
                      ("flash_dkv_f16_wide", 512): 32}
    assert chip_smoke.spill_faults(spills, chip_smoke.SPILL_GATES) == []


@pytest.mark.parametrize("wide,fault", [
    (((FWDW256, 608, 580), (DQW256, 0, 0), (DKVW256, 0, 0)),
     "flash_fwd_wide D=256: 1188 bytes spilled"),
    (((FWDW256, 0, 0), (DQW256, 0, 0), (DKVW256, 8, 0)),
     "flash_dkv_wide D=256: 8 bytes spilled"),
    (((FWDW256, 0, 0), (DQW256, 0, 0)),
     "flash_dkv_wide D=256: no ptxas spill line"),
    (((FWDW512, 0, 0), (DQW256, 0, 0), (DKVW256, 0, 0)),
     "flash_fwd_wide D=256: no ptxas spill line"),
    (((FWDW256, 0, 0), (DQW256, 12, 0), (DKVW256, 0, 0)),
     "flash_dq_wide D=256: 12 bytes spilled"),
    (((FWDW256, 0, 0), (DKVW256, 0, 0)),
     "flash_dq_wide D=256: no ptxas spill line"),
    # neither bf16's dQ above D=512 nor the wide one at 512 stands for
    # D=256
    (((FWDW256, 0, 0), (DQC128, 0, 0), (DQW512, 0, 0), (DKVW256, 0, 0)),
     "flash_dq_wide D=256: no ptxas spill line"),
    # fp16's wide forward and dK/dV, gated as the bf16 ones
    (((FWDW256, 0, 0), (DQW256, 0, 0), (DKVW256, 0, 0),
      (FWDW256_F16, 0, 0), (DKVW256_F16, 24, 24)),
     "flash_dkv_f16_wide D=256: 48 bytes spilled"),
    (((FWDW256, 0, 0), (DQW256, 0, 0), (DKVW256, 0, 0),
      (FWDW256_F16, 4, 0), (DKVW256_F16, 0, 0)),
     "flash_fwd_f16_wide D=256: 4 bytes spilled"),
    (((FWDW256, 0, 0), (DQW256, 0, 0), (DKVW256, 0, 0),
      (DKVW512_F16, 0, 0), (FWDW256_F16, 0, 0)),
     "flash_dkv_f16_wide D=256: no ptxas spill line"),
    # an fp16 wide kernel's line is not read as bf16's
    (((DKVW256_F16, 0, 0), (DQW256, 0, 0), (DKVW256, 0, 0),
      (FWDW256_F16, 0, 0)),
     "flash_fwd_wide D=256: no ptxas spill line"),
    # fp16's wide dQ, gated as the bf16 one
    (((FWDW256, 0, 0), (DQW256, 0, 0), (DKVW256, 0, 0), (DQW256_F16, 4, 4)),
     "flash_dq_f16_wide D=256: 8 bytes spilled"),
    (((FWDW256, 0, 0), (DQW256, 0, 0), (DKVW256, 0, 0), (DQW512_F16, 0, 0)),
     "flash_dq_f16_wide D=256: no ptxas spill line"),
])
def test_spill_faults_refuse_a_spill_in_a_wide_kernel_at_d256(wide, fault):
    """Each case's log also holds the fp16 wide kernels' clean lines,
    except those of a kernel the case names itself, at any width."""
    spills = chip_smoke.ptxas_spills(log_of(
        *MAIN_CLEAN, *wide, *untouched(WIDE_F16_CLEAN, wide)))
    assert chip_smoke.spill_faults(spills, chip_smoke.SPILL_GATES) == [fault]
    # the main path's gate alone does not look at the wide kernels
    assert chip_smoke.spill_faults(spills) == []


def test_wide_spills_at_384_and_512_are_only_logged():
    spills = chip_smoke.ptxas_spills(log_of(
        *MAIN_CLEAN, *WIDE_CLEAN, (FWDW512, 624, 532), (DKVW384, 100, 100),
        (DQW512, 40, 40)))
    assert chip_smoke.spill_faults(spills, chip_smoke.SPILL_GATES) == []


@pytest.mark.parametrize("chunked,fault", [
    (((FWDC128, 16, 8), (FWDC128_F16, 0, 0)),
     "flash_fwd_chunked CW=128: 24 bytes spilled"),
    (((FWDC128, 0, 0), (FWDC128_F16, 4, 4)),
     "flash_fwd_chunked_f16 CW=128: 8 bytes spilled"),
    # CW=256 (D=768, 1024) does not stand for D=640's CW=128
    (((FWDC256, 0, 0), (FWDC128_F16, 0, 0)),
     "flash_fwd_chunked CW=128: no ptxas spill line"),
])
def test_spill_faults_refuse_a_spill_in_the_chunked_forward_at_d640(
        chunked, fault):
    """The forward above D=512 is gated at D=640 (CW=128) in both dtypes;
    its spills at CW=256 are only logged."""
    spills = chip_smoke.ptxas_spills(log_of(
        *MAIN_CLEAN, *untouched(WIDE_CLEAN, chunked), *chunked,
        (FWDC256, 64, 64)))
    assert spills[("flash_fwd_chunked", 256)] == 128
    assert chip_smoke.spill_faults(spills, chip_smoke.SPILL_GATES) == [fault]
    assert chip_smoke.spill_faults(spills) == []


@pytest.mark.parametrize("chunked,fault", [
    (((DQC128_F16, 8, 16), (DKVC128_F16, 0, 0)),
     "flash_dq_chunked_f16 CW=128: 24 bytes spilled"),
    (((DQC128_F16, 0, 0), (DKVC128_F16, 4, 4)),
     "flash_dkv_chunked_f16 CW=128: 8 bytes spilled"),
    # CW=256 (D=768, 1024) does not stand for D=640's CW=128
    (((DQC128_F16, 0, 0), (DKVC256_F16, 0, 0)),
     "flash_dkv_chunked_f16 CW=128: no ptxas spill line"),
    # bf16's, gated as fp16's; neither type's line stands for the other's
    (((DQC128, 4, 4), (DKVC128, 0, 0)),
     "flash_dq_chunked CW=128: 8 bytes spilled"),
    (((DQC128, 0, 0), (DKVC256, 0, 0)),
     "flash_dkv_chunked CW=128: no ptxas spill line"),
])
def test_spill_faults_refuse_a_spill_in_the_chunked_backward_at_d640(
        chunked, fault):
    """dQ and dK/dV above D=512 are gated at D=640 (CW=128) in bf16 and
    fp16; their spills at CW=256 are only logged."""
    spills = chip_smoke.ptxas_spills(log_of(
        *MAIN_CLEAN, *untouched(WIDE_CLEAN, chunked), *chunked,
        (DQC256_F16, 8, 16)))
    assert spills[("flash_dq_chunked_f16", 256)] == 24
    assert chip_smoke.spill_faults(spills, chip_smoke.SPILL_GATES) == [fault]
    assert chip_smoke.spill_faults(spills) == []


def _fake_bwd_phase(monkeypatch, launches_per_case=2, bad=()):
    """run_chunked_backward on the CPU: kernel_errors stands in for the card,
    raising the dtype's chunked counts as a case's two launches of K2 and
    K3 would (or `launches_per_case` times) and reading `bad` at every case;
    the times are rows of the names they are given. Returns the
    kernel_errors calls (dtype, name, shape, routed K2 at D=640, twice) and
    the timings (dtype, shape, rounds)."""
    from vodascheduler_tpu_torch.ops import flash_attention as fa
    calls = []

    def kernel_errors(fa_, name, shape, dtype, limits, twice=False):
        assert limits == chip_smoke.BWD_CHUNKED_LIMITS[dtype]
        calls.append((dtype, name, shape,
                      fa_._kernel("flash_dq", 640, dtype), twice))
        if twice:
            for n in chip_smoke.BWD_CHUNKED_COUNTS[dtype]:
                fa_.launches[n] += launches_per_case
        errs = {"dq_abs": 1e-3, "dk_abs": 2e-3, "dv_abs": 3e-3}
        if dtype == torch.bfloat16:
            errs = {"dq_abs": 7e-3, "dk_abs": 9e-3, "dv_abs": 8e-3}
        if name == "d640_cuda_cores":
            errs = {"dq_abs": 4e-3, "dk_abs": 6e-3, "dv_abs": 5e-3}
        return errs, list(bad)

    timed = []

    def time_backward_turns(fa_, shape, rounds, dtype):
        timed.append((dtype, shape, rounds))
        old = (chip_smoke.OLD_BWD_ABOVE_512.values()
               if dtype == torch.float16 else ())
        return {n: {} for n in (*chip_smoke.BWD_CHUNKED_COUNTS[dtype], *old)}

    monkeypatch.setattr(chip_smoke, "kernel_errors", kernel_errors)
    monkeypatch.setattr(chip_smoke, "time_backward_turns",
                        time_backward_turns)
    return fa, calls, timed


def test_the_chunked_backward_phase_checks_every_case_and_the_old_pair(
        monkeypatch):
    """Phase 3's K2 and K3 above D=512, bf16 then fp16: every CHUNKED_CASES
    launched twice (K1, K2 and K3 held bitwise) and counted under the
    dtype's chunked names, each pair held at BWD_RECORD_SHAPE, fp16's
    CUDA-core pair there too through `routed` (bf16 has none left), each
    dtype timed at that shape (two rounds) and at d640 (one); the rows
    carry each pair's errors at the record shape."""
    fa, calls, timed = _fake_bwd_phase(monkeypatch)
    rows = chip_smoke.run_chunked_backward(fa)
    cases = chip_smoke.CHUNKED_CASES
    bf16, f16, rec = torch.bfloat16, torch.float16, chip_smoke.BWD_RECORD_SHAPE
    n = len(cases)
    for dtype, route, got in ((bf16, "flash_dq_wide", calls[:n]),
                              (f16, "flash_dq_f16_wide",
                               calls[n + 1:2 * n + 1])):
        assert [c[1:3] for c in got] == list(cases.items())
        assert all(c[0] == dtype and c[3] == route and c[4] for c in got)
    assert calls[n] == (bf16, "d640_record", rec, "flash_dq_wide", False)
    assert calls[2 * n + 1:] == [
        (f16, "d640_record", rec, "flash_dq_f16_wide", False),
        (f16, "d640_cuda_cores", rec, "flash_dq_f16_simt", False)]
    assert timed == [(bf16, rec, 2), (f16, rec, 2),
                     (bf16, cases["d640"], 1), (f16, cases["d640"], 1)]
    assert rows == {"flash_dq_chunked": {"err": 7e-3},
                    "flash_dkv_chunked": {"err": 9e-3},
                    "flash_dq_f16_chunked": {"err": 1e-3},
                    "flash_dkv_f16_chunked": {"err": 3e-3},
                    "flash_dq_f16_simt": {"err": 4e-3},
                    "flash_dkv_f16_simt": {"err": 6e-3}}
    assert rec == (2, 2, 1024, 1024, 640, True, 0)
    assert fa._kernel("flash_dq", 640, f16) == "flash_dq_f16_wide"
    assert fa._kernel("flash_dq", 640, bf16) == "flash_dq_wide"


@pytest.mark.parametrize("launches,bad,why", [
    (1, (), "launches {'flash_dq_f16_chunked': 1, "
            "'flash_dkv_f16_chunked': 1}"),
    (2, ("dq_row=0.006>0.005",), "dq_row=0.006>0.005")])
def test_the_chunked_backward_phase_fails_on_a_broken_bar_or_count(
        monkeypatch, launches, bad, why):
    fa, _, timed = _fake_bwd_phase(monkeypatch, launches, bad)
    with pytest.raises(SystemExit, match="K2 and K3 above D=512 failed"
                       ) as err:
        chip_smoke.run_chunked_backward(fa)
    assert f"d640: {why}" in str(err.value)
    assert timed == []


@pytest.mark.parametrize("f32w,fault", [
    (((FWDW128_F32, 0, 0), (DKV128_F32, 6, 6)),
     "flash_dkv_f32 CW=128: 12 bytes spilled"),
    (((FWDW128_F32, 8, 0), (DKV128_F32, 0, 0)),
     "flash_fwd_f32_wide CW=128: 8 bytes spilled"),
    # dK/dV's line at CW=64 does not stand for CW=128
    (((FWDW128_F32, 0, 0), (DKV64_F32, 0, 0)),
     "flash_dkv_f32 CW=128: no ptxas spill line"),
    # fp32's TF32 dQ at CW=128 (D=128 and every width above)
    (((FWDW128_F32, 0, 0), (DKV128_F32, 0, 0), (DQ128_F32, 4, 4)),
     "flash_dq_f32 CW=128: 8 bytes spilled"),
])
def test_spill_faults_refuse_a_spill_in_the_fp32_wide_kernels(f32w, fault):
    """fp32's TF32 forward above D=128 is gated at its one instantiation
    (CW=128, which D=256 runs), and so are its dQ and dK/dV at CW=128, which
    D=128 and every width above run; the main path's gate alone does not
    look at them."""
    others = untouched(WIDE_CLEAN, ((FWDW128_F32, 0, 0),
                                    (DKV128_F32, 0, 0), *f32w))
    spills = chip_smoke.ptxas_spills(log_of(*MAIN_CLEAN, *others, *f32w))
    assert chip_smoke.spill_faults(spills, chip_smoke.SPILL_GATES) == [fault]
    assert chip_smoke.spill_faults(spills) == []


def test_a_clean_wide_log_passes_every_gate():
    """The log of a build in which no gated kernel spills: every gate of
    phase 2 is met, the wide dQ at D=256 among them."""
    spills = chip_smoke.ptxas_spills(log_of(*MAIN_CLEAN, *WIDE_CLEAN))
    assert set(chip_smoke.SPILL_GATES) <= set(spills)
    assert ("flash_dq_wide", 256) in chip_smoke.SPILL_GATES
    assert ("flash_dkv_f16_wide", 256) in chip_smoke.SPILL_GATES
    assert ("flash_dq_f16", 64) in chip_smoke.SPILL_GATES
    assert ("flash_dq_f16_wide", 256) in chip_smoke.SPILL_GATES
    assert ("flash_fwd_f32", 64) in chip_smoke.SPILL_GATES
    assert ("flash_dkv_f32", 64) in chip_smoke.SPILL_GATES
    assert ("flash_fwd_chunked", 128) in chip_smoke.SPILL_GATES
    assert ("flash_fwd_chunked_f16", 128) in chip_smoke.SPILL_GATES
    assert ("flash_dq_chunked_f16", 128) in chip_smoke.SPILL_GATES
    assert ("flash_dkv_chunked_f16", 128) in chip_smoke.SPILL_GATES
    assert ("flash_dq_chunked", 128) in chip_smoke.SPILL_GATES
    assert ("flash_dkv_chunked", 128) in chip_smoke.SPILL_GATES
    assert ("flash_fwd_f32_wide", 128) in chip_smoke.SPILL_GATES
    assert ("flash_dkv_f32", 128) in chip_smoke.SPILL_GATES
    assert ("flash_dq_f32", 64) in chip_smoke.SPILL_GATES
    assert ("flash_dq_f32", 128) in chip_smoke.SPILL_GATES
    assert chip_smoke.spill_faults(spills, chip_smoke.SPILL_GATES) == []


@pytest.mark.parametrize("shape,products,tensors,stats,want_by", [
    ((8, 16, 2048, 2048, 64, True, 0), 2, 4, 1, "operations"),
    ((8, 16, 2048, 2048, 64, True, 0), 3, 6, 2, "operations"),
    ((8, 16, 2048, 2048, 64, True, 0), 4, 6, 2, "operations"),
    ((8, 16, 2048, 2048, 64, True, 0), 7, 8, 1, "operations"),
    ((1, 1, 64, 64, 64, False, 0), 2, 4, 1, "bytes"),
])
def test_bound_counts_the_causal_half_and_names_its_limit(shape, products,
                                                          tensors, stats,
                                                          want_by):
    ms, by = chip_smoke.bound(products, tensors, stats, *shape)
    B, H, Sq, Sk, D, causal, q_off = shape
    pairs = (Sq * (Sq + 1) // 2) if causal else Sq * Sk
    flops = products * 2 * B * H * pairs * D
    nbytes = tensors * B * Sq * H * D * 2 + stats * B * H * Sq * 4
    assert by == want_by
    assert ms == pytest.approx(1e3 * max(flops / chip_smoke.PEAK_BF16_FLOPS,
                                         nbytes / chip_smoke.PEAK_BYTES))


def test_fp32_bounds_are_at_three_tf32_passes():
    """fp32's peak is TF32's 495 TFLOP/s over three passes: K1, K2 and K3
    at the main shape take 0.4167, 0.6250 and 0.8334 ms at least."""
    import torch
    assert chip_smoke.PEAK_FLOPS[torch.float32] == pytest.approx(165e12)
    main = (8, 16, 2048, 2048, 64, True, 0)
    for products, tensors, stats, want in ((2, 4, 1, 0.4167),
                                           (3, 6, 2, 0.6250),
                                           (4, 6, 2, 0.8334)):
        ms, by = chip_smoke.bound(products, tensors, stats, *main,
                                  torch.float32)
        assert by == "operations" and ms == pytest.approx(want, abs=5e-5)


def test_attn_pairs_with_an_offset_query_slice():
    # 3 queries at positions 4, 5, 6 against 8 keys see 5 + 6 + 7 keys
    assert chip_smoke.attn_pairs(3, 8, True, 4) == 18
    assert chip_smoke.attn_pairs(3, 8, False, 4) == 24


def _moe_session(dispatch="gather"):
    """A remat mixtral_tiny session on the CPU, the attention operator
    installed as on the card."""
    import dataclasses
    import functools

    from vodascheduler_tpu_torch.models import mixtral
    from vodascheduler_tpu_torch.models.registry import mixtral_bundle
    from vodascheduler_tpu_torch.ops import flash_attention as fa
    from vodascheduler_tpu_torch.runtime import TrainSession

    cfg = dataclasses.replace(mixtral.MIXTRAL_TINY, dispatch=dispatch,
                              dtype="float32", scan_layers=True,
                              remat_layers=True, remat_policy="dots_attn")
    session = TrainSession(mixtral_bundle("moe", cfg, 64),
                           global_batch_size=2, device="cpu")
    session.module.attn_fn = functools.partial(fa.flash_attention,
                                               causal=True)
    return session


def test_slice_gaps_of_an_moe_model_replay_its_routing():
    """The comparison of chip_smoke's MoE phases on the CPU, where the two
    attentions differ only by fp32 rounding: the plain pass would have
    routed every token alike, the drop share is a share, and the gaps are
    those of bf16 expert compute, far inside the bars."""
    from vodascheduler_tpu_torch.ops import moe_dispatch

    session = _moe_session()
    gating = moe_dispatch.top_k_gating
    gaps = chip_smoke.slice_gaps(session.bundle, session.module,
                                 session.make_batch())
    assert moe_dispatch.top_k_gating is gating  # uninstalled
    assert gaps["routing_differs"] == 0
    assert 0 <= gaps["dropped_at_step0"] < 1
    assert gaps["loss"] < 1e-5 and gaps["grad"] < 1e-2
    assert chip_smoke.check_slice(gaps) == []


def test_routing_replay_pins_the_first_pass_experts():
    """A second pass whose router would choose otherwise routes by the
    first pass's experts, under checkpoint recompute too, and counts the
    tokens it overrode."""
    import torch

    session = _moe_session("routed")
    module, batch = session.module, session.make_batch()
    replay = chip_smoke.RoutingReplay(module)
    try:
        session.bundle.loss_fn(module, batch).backward()
        with torch.no_grad():
            for layer in module.layers:
                layer.moe.router.weight.mul_(-1.0)
        replay.replay = True
        seen = []
        inner = replay.gating

        def spy(probs, top_k, eps=1e-9):
            gate = inner(probs, top_k, eps)
            seen.append((replay.layer, gate.detach()))
            return gate
        from vodascheduler_tpu_torch.ops import moe_dispatch
        moe_dispatch.top_k_gating = spy
        session.bundle.loss_fn(module, batch).backward()
    finally:
        replay.remove()
    L = len(module.layers)
    assert len(seen) == 2 * L  # the forward, then each layer's recompute
    for layer, gate in seen:
        want = torch.zeros_like(gate, dtype=torch.bool).scatter(
            -1, replay.chosen[layer], True)
        assert torch.equal(gate > 0, want), layer
    assert sorted(replay.differ) == list(range(L))
    assert replay.shares(module.cfg)["routing_differs"] > 0


@pytest.mark.parametrize("name", ["bert_tiny", "vit_tiny", "mnist_mlp"])
def test_twin_gaps_of_a_family(name):
    """The families phase's twin comparison, on the CPU: the bundle's bf16
    model against an fp32 twin of the same weights stays inside its bars,
    and an fp32 model against its own twin reads 0."""
    import dataclasses

    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession

    session = TrainSession(get_model(name), global_batch_size=2,
                           device="cpu")
    batch = session.make_batch()
    gaps = chip_smoke.twin_gaps(session.bundle, session.module, batch)
    assert chip_smoke.check_twin(name, gaps) == []
    if hasattr(session.bundle.cfg, "dtype"):
        assert gaps["loss"] > 0  # the bf16 model is not its twin
        fp32 = type(session.module)(dataclasses.replace(
            session.bundle.cfg, dtype="float32"))
        fp32.load_state_dict(session.module.state_dict())
        exact = chip_smoke.twin_gaps(session.bundle, fp32, batch)
    else:
        exact = gaps
    assert exact["loss"] == 0 and exact["grad"] == 0


def test_family_twin_reads_a_name_of_twin_seeds_over_its_seeds(monkeypatch):
    """resnet50's twin reading is the mean of the worst gradient gap over
    TWIN_SEEDS seeds, each seed's session built as TrainSession(seed=s);
    a family outside TWIN_SEEDS is read at its own session alone."""
    import functools
    import statistics

    import vodascheduler_tpu_torch.runtime as runtime
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import train

    cpu_session = functools.partial(train.TrainSession, device="cpu")
    monkeypatch.setattr(runtime, "TrainSession", cpu_session)
    monkeypatch.setitem(chip_smoke.TWIN_SEEDS, "resnet_tiny", 3)
    assert chip_smoke.TWIN_SEEDS["resnet50"] == 8
    per_seed = []
    for seed in range(3):
        s = cpu_session(get_model("resnet_tiny"), global_batch_size=8,
                        seed=seed)
        per_seed.append(chip_smoke.twin_gaps(s.bundle, s.module,
                                             s.make_batch()))
    session = cpu_session(get_model("resnet_tiny"), global_batch_size=8)
    got = chip_smoke.family_twin("resnet_tiny", session,
                                 session.make_batch())
    assert got["grad_by_seed"] == [round(r["grad"], 6) for r in per_seed]
    assert got["grad"] == pytest.approx(
        statistics.fmean(r["grad"] for r in per_seed), rel=1e-12)
    assert got["loss"] == max(r["loss"] for r in per_seed)
    assert got["finite"] and got["grad_param"] == per_seed[0]["grad_param"]
    monkeypatch.delitem(chip_smoke.TWIN_SEEDS, "resnet_tiny")
    alone = chip_smoke.family_twin("resnet_tiny", session,
                                   session.make_batch())
    assert alone == per_seed[0]


def test_backward_turns_sums_each_pair_of_the_table(capsys):
    """Phase 3's fp32 backward lines: K2 then K3 of the tensor-core pair
    that a CUDA-core table maps (its dQ and dK/dV keys, not the forward's)
    and of the CUDA-core pair it maps them to, each the sum of its two
    medians in turns, beside the library's backward."""
    turns = {"flash_fwd_f32_wide": 1.5, "flash_dq_f32_wide": 2.5,
             "flash_dkv_f32_wide": 7.5, "flash_fwd_f32_simt": 9.0,
             "flash_dq_f32_simt": 10.5, "flash_dkv_f32_simt": 16.5}
    chip_smoke.backward_turns("backward_f32_wide", 256, turns,
                              chip_smoke.CUDA_CORE_F32_WIDE, 5.0, "card")
    line = capsys.readouterr().out
    assert line.startswith("time[backward_f32_wide turns] D=256 "
                           "flash_dq_f32_wide then flash_dkv_f32_wide "
                           "ms=10.0000 (flash_dq_f32_wide 2.5000;")
    assert "flash_dq_f32_simt then flash_dkv_f32_simt ms=27.0000 " in line
    assert "cuda_cores_over_tensor_cores=2.700 " in line
    assert "library_ms=5.0000 kernels_over_library=2.000 card=card" in line
    for table in (chip_smoke.CUDA_CORE_F32, chip_smoke.CUDA_CORE_F32_WIDE):
        assert [n.split("_")[1] for n in table] == ["fwd", "dq", "dkv"]
        assert all(old.endswith("_f32_simt") for old in table.values())


# ---- phase 12: one job on a process group ------------------------------------

DIST_TEXT = """agent 0 of 1: ranks 0..0 of 1 on cuda, plan MeshPlan(dp=1, fsdp=1, tp=1, sp=1, ep=1, pp=1)
distributed rank 0 of 1 backend nccl plan MeshPlan(dp=1, fsdp=1, tp=1, sp=1, ep=1, pp=1) params DTensor
resumed at step 6 on 1 chips
restore took 2.500 s
probe params 219 dtensor 219 meshes ["DeviceMesh((dp=1, fsdp=1), 'cuda', stride=(1, 1))"]
probe loss 0 10.5
warmup step 7 took 3.000 s
probe loss 1 10.4
probe loss 2 10.3
epoch 2 loss 10.300000
kernel launches {"flash_fwd": 144, "flash_dq": 72, "flash_dkv": 72, "flash_fwd_wide": 0}
checkpoint step 9 bytes 4186053774 host_copy_s 1.200 write_s 3.400
"""


def _dist_faults(text, rc=3, distributed=True, start=6, want_rc=3,
                 plain=None, **kw):
    plain = plain or {6: 10.5, 7: 10.4, 8: 10.3}
    steps = [plain.get(i, 0.0) for i in range(18)]
    run = chip_smoke.parse_dist_run(text)
    return chip_smoke.dist_run_faults(run, rc, steps, distributed, start,
                                      want_rc, **kw)


def test_phase_12_reads_a_run_and_passes_a_sound_one():
    run = chip_smoke.parse_dist_run(DIST_TEXT)
    assert run["backend"] == "nccl" and run["params"] == run["dtensor"] == 219
    assert run["resumed"] == 6 and run["restore_s"] == 2.5
    assert run["losses"] == {6: 10.5, 7: 10.4, 8: 10.3}
    assert run["checkpoint"] == (9, 4186053774, 1.2, 3.4)
    assert _dist_faults(DIST_TEXT, falling=True) == []
    # the bar is relative: 1e-3 of 10.5 passes, 2e-3 does not
    assert _dist_faults(DIST_TEXT, plain={6: 10.5 * (1 + 9e-4),
                                          7: 10.4, 8: 10.3}) == []
    assert _dist_faults(DIST_TEXT, plain={6: 10.5 * (1 + 2e-3),
                                          7: 10.4, 8: 10.3})


@pytest.mark.parametrize("edit, fault", [
    (("backend nccl", "backend gloo"), "backend gloo"),
    (("dtensor 219", "dtensor 218"), "DTensors"),
    (("probe loss 1 10.4", "probe loss 1 nan"), "step 7 loss"),
    (("\"flash_dq\": 72", "\"flash_dq\": 48"), "launches"),
    (("checkpoint step 9", "checkpoint step 6"), "checkpoint"),
    (("resumed at step 6", "resumed at step 3"), "resumed at 3"),
    (("probe loss 2 10.3\n", ""), "launches"),
])
def test_phase_12_fails_a_broken_run(edit, fault):
    text = DIST_TEXT.replace(*edit)
    assert text != DIST_TEXT
    faults = _dist_faults(text)
    assert any(fault in f for f in faults), faults


def test_phase_12_holds_the_path_and_the_exit():
    assert any("exit 0" in f for f in _dist_faults(DIST_TEXT, rc=0))
    # the one-card path must show no process group and no DTensor
    assert _dist_faults(DIST_TEXT, distributed=False)
    one_card = DIST_TEXT.replace(
        "distributed rank 0 of 1 backend nccl plan MeshPlan(dp=1, fsdp=1, "
        "tp=1, sp=1, ep=1, pp=1) params DTensor\n", "").replace(
        "dtensor 219", "dtensor 0")
    assert _dist_faults(one_card, distributed=False) == []
    rising = DIST_TEXT.replace("probe loss 2 10.3", "probe loss 2 10.6")
    assert any("do not fall" in f for f in _dist_faults(
        rising, plain={6: 10.5, 7: 10.4, 8: 10.6}, falling=True))


def test_phase_12_holds_the_moe_run_to_its_launches():
    """mixtral_small's run on the rank: one epoch from step 0 to its end
    (exit 0), DIST_MOE_LAUNCHES a step (K1 twice a layer under remat, 12
    layers), held to the plain session's losses."""
    moe = DIST_TEXT.replace("resumed at step 6 on 1 chips\n", "").replace(
        '"flash_fwd": 144, "flash_dq": 72, "flash_dkv": 72',
        '"flash_fwd": 72, "flash_dq": 36, "flash_dkv": 36')
    plain = {0: 10.5, 1: 10.4, 2: 10.3}
    kw = dict(rc=0, start=0, want_rc=0, plain=plain, falling=True)
    assert chip_smoke.DIST_MOE_LAUNCHES == {"flash_fwd": 24, "flash_dq": 12,
                                            "flash_dkv": 12}
    assert _dist_faults(moe, launches=chip_smoke.DIST_MOE_LAUNCHES,
                        **kw) == []
    assert any("launches" in f for f in _dist_faults(moe, **kw))


def test_phase_12_rehearses_on_the_cpu(monkeypatch):
    """The phase's three supervisor runs on one CPU device (gloo, no
    kernel): rank -> SIGTERM -> one-card resume -> SIGTERM -> rank resume
    to the end, every step's loss the plain session's. One thread in each
    process: the job is tiny, and the test runs beside other workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chip_smoke.run_distributed("cpu", hermetic=True)
    finally:
        torch.set_num_threads(threads)


def test_phase_12_holds_run_a_to_its_resize_acks():
    ok = [{"seq": 1, "ok": True, "path": "inplace", "num_chips": 1,
           "step": 1},
          {"seq": 2, "ok": False, "path": "restart_required",
           "reason": "resize to 2 needs a process-group change (1 devices "
                     "held across 1 processes)"}]
    assert chip_smoke.dist_resize_faults(ok) == []
    for i, edit in ((0, {"ok": False}), (0, {"path": "restart_required"}),
                    (0, {"step": 7}), (1, {"ok": True}),
                    (1, {"reason": "the job is stopping"})):
        acks = [dict(a) for a in ok]
        acks[i].update(edit)
        assert chip_smoke.dist_resize_faults(acks), (i, edit)
    assert chip_smoke.dist_resize_faults([ok[0], None])


# ---- phase 10: what a resize costs -------------------------------------------

GB = 1 << 30


def _resize_rows(**edits):
    """A sound phase-10 summary (the benchrunner's rows), with `edits` to
    the resize row's data."""
    seg = dict(zip(chip_smoke.RESIZE_SEGMENTS,
                   (100.0, 2000.0, 3000.0, 500.0, 6000.0, 8000.0, 1200.0)))
    launches = {child: {k: v * n for k, v in
                        chip_smoke.RESIZE_LAUNCHES.items()}
                for child, n in chip_smoke.RESIZE_COUNTED_STEPS.items()}
    d = {"model": "llama_350m", "batch": 8, "checkpoint_bytes": 4_190_000_000,
         "state_bytes": 4_184_421_228, "save_sync_ms": 12000.0,
         "restart_segments_ms": seg, "restart_total_ms": sum(seg.values()),
         "resize_cost_seconds": round((12000.0 + sum(seg.values())) / 1e3, 2),
         "fast_resize_ms": 3500.0, "fast_from_chips": 1, "fast_to_chips": 1,
         "fast_first_step_loss": 10.5, "fast_memory_before_bytes": 6 * GB,
         "fast_peak_bytes": 14 * GB, "prepare_next_step_loss": 10.5,
         "restart_first_step_loss": 10.5, "prepare_second_step_loss": 10.4,
         "restart_second_step_loss": 10.4, "kernel_cache_hit": True,
         "launches": launches}
    d.update(edits)
    d["resize_paths"] = [
        {"path": "fast", "seconds": (round(d["fast_resize_ms"] / 1e3, 2)
                                     if d["fast_resize_ms"] else None),
         "from_chips": d["fast_from_chips"], "to_chips": d["fast_to_chips"]},
        {"path": "cold", "seconds": d["resize_cost_seconds"]}]
    telemetry = {child: {"memory": {"0": {"allocated_bytes.all.peak":
                                          14 * GB}}}
                 for child in chip_smoke.RESIZE_COUNTED_STEPS}
    return {"meta": {"provenance": "measured", "kind": "meta", "data": {}},
            "resize:llama_350m:b8": {"provenance": "measured",
                                     "kind": "resize", "data": d,
                                     "telemetry": telemetry}}


def test_phase_10_passes_a_sound_fast_row():
    assert chip_smoke.resize_faults(_resize_rows(), 80 * GB) == []


@pytest.mark.parametrize("edits, fault", [
    ({"fast_resize_ms": None, "fast_error": "RuntimeError: no"},
     "fast row"),
    ({"fast_to_chips": 2}, "fast row"),
    ({"fast_first_step_loss": 10.5 * (1 + 2e-5)}, "in-place resize"),
    ({"fast_first_step_loss": float("nan")}, "in-place resize"),
    ({"fast_peak_bytes": None}, "across the resize"),
    ({"fast_peak_bytes": 81 * GB}, "across the resize"),
])
def test_phase_10_fails_a_broken_fast_row(edits, fault):
    faults = chip_smoke.resize_faults(_resize_rows(**edits), 80 * GB)
    assert any(fault in f for f in faults), faults


def test_phase_10_counts_the_fast_childs_step():
    rows = _resize_rows()
    launches = rows["resize:llama_350m:b8"]["data"]["launches"]
    launches["fast"] = dict(launches["prepare"])  # every warm step counted
    faults = chip_smoke.resize_faults(rows, 80 * GB)
    assert any(f.startswith("fast child launched") for f in faults), faults
    del launches["fast"]
    assert any("launches of" in f for f in chip_smoke.resize_faults(
        rows, 80 * GB))
