"""The port's CUDA kernels against their plain versions, and the session
that runs them, on the card.

Marked `cuda`: each test skips without a CUDA device (decided inside the
fixture, never at import). On a machine with an H100 and nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine need
not have.) The bars are chip_smoke.py's `LIMITS`: O, dq, dk and dv each
held row by row to ||err|| / ||ref|| (`row_err`), lse and δ by max abs
error.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import LIMITS, row_err  # noqa: E402
from vodascheduler_tpu_torch.ops import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("causal,S,D,q_off,Sq", [
    (True, 256, 64, 0, 256),
    (False, 200, 64, 0, 200),
    (True, 192, 128, 0, 192),
    (True, 256, 64, 128, 128),
    # edges of the 128-row tiles of the forward and dK/dV kernels: less
    # than one tile of queries behind an offset, one full and one partial
    # tile, and a partial tile at D=128
    (True, 256, 64, 192, 64),
    (True, 320, 64, 0, 320),
    (False, 320, 64, 0, 320),
    (True, 200, 128, 0, 200),
    # edges of the dQ kernel's 128-row tiles: one row past a tile, a
    # partial query tile behind an offset against a ragged Sk, and less
    # than one tile at D=128
    (True, 129, 64, 0, 129),
    (True, 328, 64, 128, 200),
    (True, 64, 128, 0, 64),
])
def test_kernels_match_plain_versions(cuda, causal, S, D, q_off, Sq):
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(2, Sq, 3, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, S, 3, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    do = torch.randn(2, Sq, 3, D, generator=g, device=cuda).bfloat16()
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal,
                                              q_off)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                            q_off)
    torch.cuda.synchronize()
    assert row_err(o, o_ref) <= LIMITS["o_row"]
    assert (lse - lse_ref).abs().max().item() <= LIMITS["lse"]
    assert (delta - delta_ref).abs().max().item() <= LIMITS["delta"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= LIMITS[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


@pytest.mark.parametrize("D", [16, 32, 96])
def test_padded_kernels_match_plain_versions(cuda, D):
    """Heads the kernels are not built for: the operator's padded path
    (zeros along D to 64 or 128, D's own scale, outputs cut back) through
    the three kernels against the plain versions at D itself."""
    g = torch.Generator(cuda).manual_seed(4)
    q, k, v, do = (torch.randn(2, 200, 3, D, generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    before = dict(fa.launches)
    o, lse = fa.padded_forward(fa.flash_fwd, q, k, v, True, 0)
    dq, dk, dv = fa.padded_backward(fa.flash_dq, fa.flash_dkv, q, k, v, o,
                                    do, lse, True, 0)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, 0)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, True, 0)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta_ref,
                                            True, 0)
    torch.cuda.synchronize()
    assert o.shape == q.shape and dk.shape == k.shape
    assert row_err(o, o_ref) <= LIMITS["o_row"]
    assert (lse - lse_ref).abs().max().item() <= LIMITS["lse"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= LIMITS[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


@pytest.mark.parametrize("model", ["llama_tiny", "mixtral_tiny"])
def test_narrow_heads_train_through_the_kernels(cuda, model, monkeypatch):
    """The tiny bundles (head width 16) take a step on the card with the
    kernels installed by default, and the kernels run: 2 layers."""
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)
    session = TrainSession(get_model(model), global_batch_size=2,
                           device=cuda)
    batch = session.make_batch()
    fa.reset_launches()
    loss = session.train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fa.launches["flash_fwd"] >= 2
    assert fa.launches["flash_dq"] == fa.launches["flash_dkv"] == 2


def test_local_backend_holds_nothing_on_the_card(cuda, tmp_path):
    """The GPU backend counts the cards without creating a CUDA context:
    in a fresh process, building it leaves torch.cuda uninitialised."""
    import subprocess
    code = ("import torch\n"
            "from vodascheduler_tpu_torch.cluster.local import LocalBackend\n"
            f"b = LocalBackend({str(tmp_path)!r})\n"
            "print(b.chips, torch.cuda.is_initialized())\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr
    chips, initialised = out.stdout.split()
    assert int(chips) == torch.cuda.device_count() and initialised == "False"


def test_autograd_goes_through_the_kernels(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 128, 2, 64, generator=g, device=cuda)
               .bfloat16().requires_grad_() for _ in range(3))
    fa.reset_launches()
    fa.flash_attention(q, k, v).float().sum().backward()
    assert fa.launches == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())


def test_dq_is_deterministic(cuda):
    """No atomics in K2: two launches on the same inputs give bitwise-equal
    dq and δ."""
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v, do = (torch.randn(2, 320, 3, 64, generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, 0)
    dq1, delta1 = fa.flash_dq(q, k, v, o, do, lse, True, 0)
    dq2, delta2 = fa.flash_dq(q, k, v, o, do, lse, True, 0)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2)
    assert torch.equal(delta1, delta2)


# A Llama small enough for a test whose heads are the kernels' width (64).
SMALL = dict(vocab_size=256, dim=128, num_layers=2, num_heads=2,
             num_kv_heads=1, mlp_hidden=256, max_seq_len=128,
             rope_base=10000.0, scan_layers=True, remat_layers=True)


def _small_bundle(policy, optimizer):
    from vodascheduler_tpu_torch.models import llama
    from vodascheduler_tpu_torch.models.registry import llama_bundle
    cfg = llama.LlamaConfig(**SMALL, remat_policy=policy)
    return llama_bundle(f"small_{policy}", cfg, 128, optimizer)


@pytest.mark.parametrize("policy,fwd", [(None, 4), ("dots", 4),
                                        ("attn_out", 2), ("dots_attn", 2)])
def test_remat_policy_sets_the_forward_launches(cuda, policy, fwd):
    """A policy that keeps the attention output spares the recompute its
    K1 launch: 2 layers, one step."""
    from vodascheduler_tpu_torch.runtime import TrainSession
    session = TrainSession(_small_bundle(policy, "adafactor"),
                           global_batch_size=2, device=cuda)
    batch = session.make_batch()
    fa.reset_launches()
    loss = session.train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fa.launches == {"flash_fwd": fwd, "flash_dq": 2, "flash_dkv": 2}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_resume_on_the_card_continues_the_run(cuda, tmp_path, optimizer):
    """4 steps, a checkpoint, a fresh session resumed from it and 4 more
    steps give the losses and weights of 8 straight steps."""
    from vodascheduler_tpu_torch.runtime import TrainSession
    bundle = _small_bundle("dots_attn", optimizer)
    straight = TrainSession(bundle, global_batch_size=2, device=cuda)
    want = [straight.train_step(straight.make_batch()).item()
            for _ in range(8)]
    first = TrainSession(bundle, global_batch_size=2, device=cuda)
    got = [first.train_step(first.make_batch()).item() for _ in range(4)]
    first.save(str(tmp_path))
    second = TrainSession.resume(bundle, 1, str(tmp_path),
                                 global_batch_size=2, device=cuda)
    assert second.step == 4
    got += [second.train_step(second.make_batch()).item() for _ in range(4)]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for (name, p), q in zip(second.module.named_parameters(),
                            straight.module.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=0, msg=name)


# A Mixtral small enough for a test, at the kernels' head width (64).
SMALL_MOE = dict(vocab_size=256, dim=128, num_layers=2, num_heads=2,
                 num_kv_heads=1, mlp_hidden=256, num_experts=4, top_k=2,
                 rope_base=10000.0, dispatch="gather", scan_layers=True,
                 remat_layers=True)


@pytest.mark.parametrize("policy,fwd", [(None, 4), ("dots", 4),
                                        ("attn_out", 2), ("dots_attn", 2)])
def test_mixtral_remat_policy_sets_the_forward_launches(cuda, policy, fwd):
    """The policies apply to Mixtral's layers as to Llama's: 2 layers, one
    step, K1 once more per layer unless the attention output is kept."""
    from vodascheduler_tpu_torch.models import mixtral
    from vodascheduler_tpu_torch.models.registry import mixtral_bundle
    from vodascheduler_tpu_torch.runtime import TrainSession
    cfg = mixtral.MixtralConfig(**SMALL_MOE, remat_policy=policy)
    session = TrainSession(mixtral_bundle(f"moe_{policy}", cfg, 128,
                                          "adafactor"),
                           global_batch_size=2, device=cuda)
    batch = session.make_batch()
    fa.reset_launches()
    loss = session.train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fa.launches == {"flash_fwd": fwd, "flash_dq": 2, "flash_dkv": 2}


def test_dispatches_agree_on_the_card(cuda):
    """At capacity factor 100 nothing drops, and the three dispatches
    compute one function: gather equals routed at 1e-2, dense at 5e-2 (the
    reference's bars for the pairs, tests/test_models.py)."""
    import dataclasses

    from vodascheduler_tpu_torch.models import mixtral
    cfg = dataclasses.replace(mixtral.MixtralConfig(**SMALL_MOE),
                              capacity_factor=100.0)
    g = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(2, 256, cfg.dim, generator=g, device=cuda).bfloat16()
    torch.manual_seed(0)
    blocks = {d: mixtral.MoEBlock(dataclasses.replace(cfg, dispatch=d),
                                  device=cuda) for d in mixtral.DISPATCHES}
    state = blocks["gather"].state_dict()
    with torch.no_grad():
        out = {}
        for d, block in blocks.items():
            block.load_state_dict(state)
            out[d] = block(x).float()
    assert torch.isfinite(out["gather"]).all()
    assert (out["gather"] - out["routed"]).abs().max().item() < 1e-2
    assert (out["dense"] - out["routed"]).abs().max().item() < 5e-2
