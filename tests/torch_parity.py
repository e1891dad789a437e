"""The comparison the port's parity tests share: assert_allclose that also
prints the largest absolute error, so a run with `-s` lists the errors the
parity table of PERF.md records:

    python -m pytest -s -q -p no:randomly tests/test_torch_*.py | grep '^parity'
"""

import numpy as np


def _np(x):
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().float().numpy()
    return np.asarray(x, dtype=np.float64)


def assert_close(name: str, got, want, atol: float, rtol: float) -> None:
    got, want = _np(got), _np(want)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    print(f"parity {name}: max_abs_err={err:.3g} (atol {atol:g}, "
          f"rtol {rtol:g})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=name)
