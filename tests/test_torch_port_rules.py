"""Rules the port keeps: it never imports JAX or the JAX package, its entry
points run on the card unless asked for the CPU, and its kernel wrappers
send CPU tensors to the plain twins without counting a launch."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import fibergen_tpu_torch as ft
from fibergen_tpu_torch.ops import green, spectral_kernels, stencil_kernels

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "fibergen_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "fibergen_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "scripts" / "torch_profile_solve.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_forbidden_matches_prefix_only_at_module_boundary():
    assert _forbidden("fibergen_tpu") and _forbidden("fibergen_tpu.ops.fft")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("fibergen_tpu_torch")
    assert not _forbidden("fibergen_tpu_torch.ops")
    assert not _forbidden("jaxlib_like")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    phi = np.zeros((4, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.convert.material_from_numpy([("a", 1.0, 1.0, phi)])
    mat = ft.convert.material_from_numpy([("a", 1.0, 1.0, phi)],
                                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.LSSolver(ft.Grid(4, 4, 4), mat)
    assert ft.LSSolver(ft.Grid(4, 4, 4), mat, device="cpu").device.type \
        == "cpu"


def test_unported_options_raise():
    mat = ft.convert.material_from_numpy([("a", 1.0, 1.0, np.ones((4, 4, 4)))],
                                         device="cpu")
    for kw in ({"method": "polarization"}, {"mode": "hyperelasticity"},
               {"gamma_scheme": "full_staggered"}, {"loadsteps": 3},
               {"use_pallas": "on"}, {"error_estimator": "energy"}):
        with pytest.raises(NotImplementedError):
            ft.LSSolver(ft.Grid(4, 4, 4), mat, ft.SolverOptions(**kw),
                        device="cpu")
    s = ft.LSSolver(ft.Grid(4, 4, 4), mat, ft.SolverOptions(
        dtype="float32", tol=1e-8), device="cpu")
    s.set_strain([1.0, 0, 0, 0, 0, 0])
    with pytest.raises(NotImplementedError, match="refinement"):
        s.run()


def test_cpu_tensors_take_the_twins_and_count_no_launch():
    grid = ft.Grid(5, 4, 3)
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))
    before = dict(stencil_kernels.launches, **spectral_kernels.launches)
    f, p = stencil_kernels.stress_div_beta(
        grid, t(6, 5, 4, 3), t(6, 5, 4, 3), torch.tensor(0.5),
        t(5, 4, 3), t(5, 4, 3), 1.0, 0.0)
    w, dot = stencil_kernels.eps_from_u_dot(grid, t(6), t(3, 5, 4, 3), p)
    u = green.g0_staggered_fused(grid, 1.0, 0.0, f)
    assert f.shape == (3, 5, 4, 3) and w.shape == (6, 5, 4, 3)
    assert dot.shape == () and u.shape == (3, 5, 4, 3)
    f, p, ts = stencil_kernels.stress_div_beta(
        grid, t(6, 5, 4, 3), None, None, t(5, 4, 3), t(5, 4, 3), 1.0, 0.0,
        want_tau_sum=True)
    w, dot = stencil_kernels.eps_from_u_dot(grid, t(6), t(3, 5, 4, 3),
                                            t(6, 5, 4, 3), mu_x=t(5, 4, 3),
                                            tau2c=-0.5, mu0=1.0)
    h = green.g0_staggered_heat_fused(grid, 1.0, 0.0, f[:1])
    assert p is None and ts.shape == (6,) and dot.shape == ()
    assert h.shape == (1, 5, 4, 3)
    assert dict(stencil_kernels.launches, **spectral_kernels.launches) \
        == before
