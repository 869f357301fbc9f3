"""The port's grid tables and field reductions equal the JAX package's."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fibergen_tpu.core import fields as jfields
from fibergen_tpu.core.grid import Grid as JGrid
from fibergen_tpu.core.grid import _freq_index as j_freq
from fibergen_tpu.core.grid import _rfreq_index as j_rfreq
from fibergen_tpu_torch.core import fields
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


def test_inner_products_match():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((6, 7, 5, 9)) for _ in range(3))
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
