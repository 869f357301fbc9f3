"""The port's grid tables, field reductions and linear materials equal the
JAX package's."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fibergen_tpu.core import fields as jfields
from fibergen_tpu.core import voigt as jvoigt
from fibergen_tpu.core.grid import Grid as JGrid
from fibergen_tpu.core.grid import _freq_index as j_freq
from fibergen_tpu.core.grid import _rfreq_index as j_rfreq
from fibergen_tpu.materials import laws as jlaws
from fibergen_tpu.materials import mixing as jmixing
from fibergen_tpu_torch import convert
from fibergen_tpu_torch.core import fields, voigt
from fibergen_tpu_torch.core.grid import Grid, _freq_index, _rfreq_index

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 15, 16])
def test_freq_index_matches(n):
    np.testing.assert_array_equal(_freq_index(n), j_freq(n))
    np.testing.assert_array_equal(_rfreq_index(n), j_rfreq(n))
    if n % 2 == 0 and n > 1:
        assert _freq_index(n)[n // 2] == -n / 2   # Nyquist bin is -n/2


@pytest.mark.parametrize("shape,cell", [
    ((15, 13, 11), (1.0, 1.0, 1.0)),
    ((16, 12, 10), (2.0, 0.5, 1.3)),
])
def test_staggered_tables_match(shape, cell):
    g = Grid(*shape, dx=cell[0], dy=cell[1], dz=cell[2])
    jg = JGrid(*shape, dx=cell[0], dy=cell[1], dz=cell[2])
    for a, b in zip(g.xi_staggered(), jg.xi_staggered()):
        np.testing.assert_array_equal(a, b)
    assert g.staggered_h() == jg.staggered_h()
    assert g.rshape == jg.rshape and g.nxyz == jg.nxyz


@pytest.mark.parametrize("dim", [3, 6])
def test_voigt_weights_match(dim):
    np.testing.assert_array_equal(voigt.weights(dim), jvoigt.weights(dim))
    if dim == 3:
        np.testing.assert_array_equal(voigt.weights(3), np.ones(3))


def test_inner_products_match():
    _check_reductions(6)


def test_inner_products_match_on_dim3_fields():
    _check_reductions(3)


def _check_reductions(dim):
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((dim, 7, 5, 9)) for _ in range(3))
    ta, tb, tc = (torch.as_tensor(x) for x in (a, b, c))
    ja, jb, jc = (jnp.asarray(x) for x in (a, b, c))
    assert float(fields.inner_l2(ta, tb)) == pytest.approx(
        float(jfields.inner_l2(ja, jb)), rel=1e-13, abs=1e-15)
    assert float(fields.inner_l2_diff(ta, tb, tc)) == pytest.approx(
        float(jfields.inner_l2_diff(ja, jb, jc)), rel=1e-13, abs=1e-15)
    np.testing.assert_allclose(fields.component_norm(ta).numpy(),
                               np.asarray(jfields.component_norm(ja)),
                               rtol=1e-13)
    np.testing.assert_allclose(fields.mean(ta).numpy(),
                               np.asarray(jfields.mean(ja)), rtol=1e-13,
                               atol=1e-15)


@pytest.mark.parametrize("dim", [3, 6])
def test_const_field(dim):
    from fibergen_tpu_torch.core.grid import Grid
    vals = np.arange(1.0, dim + 1.0)
    t = fields.const_field(Grid(3, 4, 5), vals, torch.float64, "cpu")
    assert t.shape == (dim, 3, 4, 5) and t.is_contiguous()
    np.testing.assert_array_equal(fields.mean(t).numpy(), vals)


@pytest.mark.parametrize("dim,zero_trace", [(3, False), (6, True), (6, False)])
def test_scalar_law_mixing_matches_jax(dim, zero_trace):
    """ScalarLinearIsotropic phases under the Voigt rule (heat/porous on dim
    3, viscosity fluidity on dim 6): the 0.5 of iso_moduli, pk1, the stress
    difference, the mean stress and the tangent bounds."""
    rng = np.random.default_rng(1)
    shape = (5, 4, 3)
    phi = rng.random(shape)
    mus = (10.0, 0.25)
    jmat = jmixing.VoigtMixed([
        jmixing.Phase("a", jlaws.ScalarLinearIsotropic(mu=mus[0], dim=dim),
                      jnp.asarray(phi)),
        jmixing.Phase("b", jlaws.ScalarLinearIsotropic(mu=mus[1], dim=dim),
                      jnp.asarray(1.0 - phi))], dim=dim)
    mat = convert.material_from_numpy(
        [("a", mus[0], phi), ("b", mus[1], 1.0 - phi)], dim=dim,
        device="cpu", law="scalar")
    assert [p.law.iso_moduli() for p in mat.phases] == [
        p.law.iso_moduli() for p in jmat.phases] == [(5.0, 0.0), (0.125, 0.0)]
    F = rng.standard_normal((dim,) + shape)
    tF, jF = torch.as_tensor(F), jnp.asarray(F)
    np.testing.assert_allclose(mat.pk1(tF).numpy(), np.asarray(jmat.pk1(jF)),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        mat.stress_diff(tF, 1.3, 0.0).numpy(),
        np.asarray(jmat.stress_diff(jF, 1.3, 0.0)), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(mat.mean_pk1(tF).numpy(),
                               np.asarray(jmat.mean_pk1(jF)), rtol=1e-13,
                               atol=1e-15)
    lo, hi = mat.eig_range(zero_trace=zero_trace)
    jlo, jhi = jmat.eig_range(jF, zero_trace=zero_trace)
    assert (float(lo), float(hi)) == (float(jlo), float(jhi))
