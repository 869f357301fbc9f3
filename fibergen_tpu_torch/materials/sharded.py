"""A material's responses on the x-slabs of a sharded solve.

The Voigt rule over laws without fields runs on x-slabs itself
(materials/mixing.py: the mixed moduli and phi split into the slabs).
Every other material goes through :class:`SlabMaterial`, which evaluates
it slab by slab on its per-slab views (``MixedMaterial.slab_views``: the
material over the slab's cut of phi, of the orientation fields, of the
selector rules' weights and of the interface normals); the stresses, the
tangent, the energy and the polarization are voxel-local, the means add
the slabs' means in slab order, and the eigenvalue bounds reduce over the
slabs.  The doubly-fine grid (materials/dfg.py) prolongs and restricts on
slabs with one halo plane and evaluates its inner material so.
:func:`for_slabs` picks the layout a solver's material takes.
"""
from __future__ import annotations

import torch

from ..core import fields
from ..parallel import Mesh, slabs
from . import laws
from .dfg import DfgMaterial
from .mixing import MixedMaterial, VoigtMixed, _reduce_bounds


def for_slabs(mat):
    """``mat`` laid out for a sharded solve: itself where it takes x-slabs
    (the Voigt rule over laws that read no field), a doubly-fine material
    over its inner material so laid out, else a :class:`SlabMaterial`."""
    if isinstance(mat, DfgMaterial):
        return DfgMaterial(for_slabs(mat.inner))
    if isinstance(mat, SlabMaterial) or (
            type(mat) is VoigtMixed and all(
                getattr(p.law, "orientation", None) is None
                for p in mat.phases)):
        return mat
    return SlabMaterial(mat)


class SlabMaterial:
    """A mixed material evaluated on x-slabs through its slab views, built
    once per mesh and per state (the tensors it reads, ``state()``); a
    whole field goes to the material itself.  Every other attribute is the
    material's (its phases, rule, isotropic moduli and their slabs)."""

    def __init__(self, inner):
        self.inner = inner
        self._views = None

    def __getattr__(self, name):
        if name == "inner":         # not set yet (copy, unpickling)
            raise AttributeError(name)
        return getattr(self.inner, name)

    def views(self, F):
        """The views of the slabs of ``F`` (a list of x-slabs)."""
        devices = tuple(f.device for f in F)
        key = self.inner.state()
        c = self._views
        if c is None or c[1] != devices or len(c[0]) != len(key) \
                or not all(a is b for a, b in zip(c[0], key)):
            self._views = (key, devices,
                           self.inner.slab_views(Mesh(devices)))
        return self._views[2]

    def _each(self, name, F, *more):
        """The view's ``name`` on each slab of F (and of each sharded
        argument in ``more``); the material's own on a whole F."""
        if not slabs.sharded(F):
            return getattr(self.inner, name)(F, *more)
        return [getattr(v, name)(*(slabs.part(a, i) for a in (F,) + more))
                for i, v in enumerate(self.views(F))]

    def pk1(self, F):
        return self._each("pk1", F)

    def dpk1(self, F, W):
        return self._each("dpk1", F, W)

    def w(self, F):
        return self._each("w", F)

    def stress_diff(self, F, mu_0, lambda_0):
        return self._each("stress_diff", F, mu_0, lambda_0)

    # each case slab by slab in turn (``out``: a list of sharded rows)
    stress_diffs = MixedMaterial.stress_diffs

    def polarization(self, mu_0, F, inv=False):
        if not slabs.sharded(F):
            return self.inner.polarization(mu_0, F, inv)
        return [v.polarization(mu_0, f, inv)
                for v, f in zip(self.views(F), F)]

    def mean_pk1(self, F):
        return fields.mean(self.pk1(F))

    def mean_w(self, F):
        return slabs.vmean(torch.mean, self.w(F))

    def mean_cauchy(self, F):
        if self.inner.dim != 9:
            return self.mean_pk1(F)
        return fields.mean(slabs.smap(laws.cauchy_from_pk1_comp, self.pk1(F),
                                      F))

    def eig_range(self, F=None, zero_trace=False, devices=None):
        """The linear bounds are the material's (per slab of its mixed
        moduli with ``devices``); the tangent's bounds at a sharded F
        reduce the views' over the slabs."""
        if F is None or not slabs.sharded(F):
            return self.inner.eig_range(F, zero_trace, devices)
        return _reduce_bounds([v.eig_range(f, zero_trace)
                               for v, f in zip(self.views(F), F)])

    def __str__(self):
        return str(self.inner)
