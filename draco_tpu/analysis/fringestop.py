"""Fringe-rate mixing of visibilities.

JAX re-design of reference ``draco/analysis/fringestop.py``
(Mix:10, DownMix:130, UpMix:136): multiplying a stream by the fringe
phasor of a field-centre source slows its fringing so the time axis can
be decimated.  The phasor over the whole (freq, baseline[, el], ra)
grid is evaluated and applied in one jitted device kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import io
from ..core.task import ContainerTask

_C_MS = 299792458.0


@jax.jit
def _mix_kernel(vre, vim, omega, phi):
    """Apply ``exp(i omega phi)`` to ``vre + i vim``.

    omega broadcasts against the leading vis axes; ``phi`` is the
    trailing (RA / time) axis in radians.
    """
    ang = omega[..., None] * phi
    c, s = jnp.cos(ang), jnp.sin(ang)
    return vre * c - vim * s, vre * s + vim * c


class Mix(ContainerTask):
    r"""Multiply a stream by a fringe phasor in earth-rotation angle.

    The mixing frequency ``omega = 2 pi b_ew cos(dec) / lambda`` is the
    fringe rate of a source at the field centre; down-mixing (the
    default) cancels that fringing.  Works on both stacked streams
    (``vis[freq, stack, ra|time]``) and hybrid beamformed streams
    (``vis[pol, freq, ew, el, ra]``).  Semantics of reference
    ``draco/analysis/fringestop.py:10-127``.
    """

    def setup(self, manager):
        """Keep the telescope model (feed positions, latitude, LSA)."""
        self.telescope = io.get_telescope(manager)

    # -- geometry helpers ------------------------------------------------

    def _ew_and_mask(self, stream):
        """EW baseline separation (m) and an optional product mask."""
        if "ew" in stream.index_map:
            return np.asarray(stream.index_map["ew"])[:, np.newaxis], None

        pairs = stream.prodstack
        pos = self.telescope.feedpositions[:, 0]
        sep = pos[pairs["input_a"]] - pos[pairs["input_b"]]
        keep = self.telescope.feedmask[
            (pairs["input_a"], pairs["input_b"])
        ].astype(float)
        return sep, keep[np.newaxis, :, np.newaxis]

    def _rotation_angle(self, stream):
        """Earth-rotation angle samples in radians."""
        if "ra" in stream.index_map:
            return np.radians(np.asarray(stream.ra))
        return np.radians(
            self.telescope.unix_to_lsa(np.asarray(stream.time))
        )

    def _cos_dec(self, stream):
        """cos(declination) of each pointing (scalar or per-el row)."""
        if "el" in stream.index_map:
            el = np.asarray(stream.index_map["el"])[np.newaxis, :]
            return np.cos(np.arcsin(el) + np.radians(self.telescope.latitude))
        offset = getattr(self.telescope, "elevation_pointing_offset", 0.0)
        return np.cos(np.radians(self.telescope.latitude + offset))

    # -- the task --------------------------------------------------------

    def process(self, stream):
        """Mix ``stream`` in place and return it."""
        hybrid = "ew" in stream.index_map
        sep, prod_mask = self._ew_and_mask(stream)
        phi = self._rotation_angle(stream)

        wavenumber = np.asarray(stream.freq) * 1e6 / _C_MS
        geom = sep * self._cos_dec(stream)
        omega = (
            2.0
            * np.pi
            * wavenumber.reshape((-1,) + (1,) * np.ndim(geom))
            * geom
        )
        if self.conjugate:
            omega = -omega
        if hybrid:
            omega = omega[np.newaxis]  # pol axis

        vis = np.asarray(stream.vis[:])
        weight = np.asarray(stream.weight[:])
        if prod_mask is not None:
            vis = vis * prod_mask
            weight = weight * prod_mask

        re, im = _mix_kernel(
            jnp.asarray(np.ascontiguousarray(vis.real)),
            jnp.asarray(np.ascontiguousarray(vis.imag)),
            jnp.asarray(omega),
            jnp.asarray(phi),
        )

        stream.vis[:] = (np.asarray(re) + 1.0j * np.asarray(im)).astype(
            stream.vis.dtype
        )
        stream.weight[:] = weight.astype(stream.weight.dtype)
        stream.attrs["fringestopped"] = not self.conjugate
        return stream


class DownMix(Mix):
    """Remove the field-centre fringing (reference fringestop.py:130)."""

    conjugate = False


class UpMix(Mix):
    """Restore the fringing of a down-mixed stream (reference
    fringestop.py:136)."""

    conjugate = True
