"""Effective-beam streams for ring-map deconvolution.

JAX re-design of reference ``draco/analysis/beam.py``
(CreateBeamStream:25, CreateBeamStreamFromTelescope:159): a beam model
sampled in celestial coordinates is turned into a
:class:`~draco_tpu.core.containers_spec.HybridVisStream` carrying the
effective beam transfer function on the data's (ew, el, ra) grid.  The
fringe phasor over the full (freq, ew, dec, ha) grid and the el-averaged
weights are evaluated in one jitted device kernel (the reference builds
the same phasor with broadcast numpy on host).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import containers, io
from ..core.task import ContainerTask
from ..ops.interferometry import projected_distance
from ..ops.tools import invert_no_zero

_C_MS = 299792458.0


@jax.jit
def _phased_beam_kernel(b_re, b_im, bweight, ha, dec, u, v, lat):
    """Rotate the beam by the conjugate fringe phasor; el-average weights.

    b_re, b_im : [pol, freq, input, dec, ha] beam planes
    bweight : [freq, pol, input, dec, ha] beam weights
    ha, dec : [nha], [ndec] radians
    u, v : [freq, ew] rotated EW/NS baseline lengths in wavelengths
    lat : latitude in radians

    Returns the phased beam planes [pol, freq, ew(broadcast), dec, ha]
    and the el-averaged weight [freq, pol, input, ha].
    """
    dist = projected_distance(
        ha[None, None, None, :],
        lat,
        dec[None, None, :, None],
        u[:, :, None, None],
        v[:, :, None, None],
    )
    ang = 2.0 * jnp.pi * dist  # conjugate of the fringestop phasor
    c, s = jnp.cos(ang), jnp.sin(ang)

    # broadcast [pol, freq, input, dec, ha] x [freq, ew, dec, ha]
    out_re = b_re * c[None] - b_im * s[None]
    out_im = b_re * s[None] + b_im * c[None]

    nonzero = (bweight > 0).astype(bweight.dtype)
    wavg = jnp.sum(bweight, axis=-2) * invert_no_zero(
        jnp.sum(nonzero, axis=-2)
    )
    return out_re, out_im, wavg


class CreateBeamStream(ContainerTask):
    """Lay a celestial GridBeam onto a HybridVisStream's (el, RA) grid.

    The output carries ``beam * exp(+2 pi i b.n(ha, dec))`` — the
    conjugate fringe phasor undoes the phase the (unrotated) NS
    beamformer applied, including the telescope rotation angle.
    Semantics of reference ``draco/analysis/beam.py:25-156``.
    """

    telescope = None

    def setup(self, telescope):
        """Capture the telescope model (latitude, rotation angle)."""
        self.telescope = io.get_telescope(telescope)
        lat = self.telescope.latitude
        rot = getattr(self.telescope, "rotation_angle", 0.0)
        self.log.info(
            f"Telescope model: latitude {lat:.4f} deg, rotation {rot:.4f} deg."
        )

    @staticmethod
    def _ra_placement(ha):
        """Indices placing the beam's hour angles onto a full-RA grid."""
        ra = (np.asarray(ha) + 360.0) % 360.0
        nra = round(360.0 / abs(ha[1] - ha[0]))
        cell = 360.0 / nra
        idx = np.rint(ra / cell).astype(int)
        if not np.allclose(ra / cell, idx, atol=1e-4):
            raise ValueError(
                "The beam's hour-angle sampling does not divide 360 deg "
                "evenly, so it cannot be scattered onto an RA grid."
            )
        return idx, nra

    def process(self, data, beam):
        """Build the effective-beam HybridVisStream for ``data``.

        Parameters
        ----------
        data : containers.HybridVisStream
            Supplies the (ew, el, freq) grid the beam is mapped onto.
        beam : containers.GridBeam
            Celestial beam model; its theta axis is declination.
        """
        if beam.coords != "celestial":
            raise RuntimeError(
                "CreateBeamStream needs a GridBeam sampled in celestial "
                f"coordinates; got {beam.coords!r}."
            )

        lat = self.telescope.latitude
        dec = np.asarray(beam.theta)
        if not np.allclose(
            np.sin(np.radians(dec - lat)), np.asarray(data.index_map["el"])
        ):
            raise RuntimeError(
                "Beam declinations do not line up with the data's el axis."
            )

        ha = np.asarray(beam.phi)
        map_ra, nra = self._ra_placement(ha)

        # Rotated baseline components in wavelengths, [freq, ew]
        wavelength = _C_MS * 1e-6 / np.asarray(beam.freq)
        b_ew = np.asarray(data.index_map["ew"])[None, :] / wavelength[:, None]
        rot = np.radians(getattr(self.telescope, "rotation_angle", 0.0))

        bvis = np.asarray(beam.beam[:]).swapaxes(0, 1)  # [pol, freq, inp, ...]
        re, im, wavg = _phased_beam_kernel(
            jnp.asarray(np.ascontiguousarray(bvis.real)),
            jnp.asarray(np.ascontiguousarray(bvis.imag)),
            jnp.asarray(np.asarray(beam.weight[:])),
            jnp.asarray(np.radians(ha)),
            jnp.asarray(np.radians(dec)),
            jnp.asarray(np.cos(rot) * b_ew),
            jnp.asarray(np.sin(rot) * b_ew),
            np.radians(lat),
        )

        out = containers.HybridVisStream(ra=nra, axes_from=data, attrs_from=data)

        vis = np.asarray(out.vis[:])
        vis[..., map_ra] = np.asarray(re) + 1.0j * np.asarray(im)
        out.vis[:] = vis

        weight = np.asarray(out.weight[:])
        weight[..., map_ra] = np.asarray(wavg).swapaxes(0, 1)
        out.weight[:] = weight
        return out


class CreateBeamStreamFromTelescope(CreateBeamStream):
    """Same, but evaluating the telescope's own beam model.

    Semantics of reference ``draco/analysis/beam.py:159-257``; each
    needed (feed, freq) beam is evaluated once over the whole (dec, ha)
    grid and reused across polarisation pairs.
    """

    def process(self, data):
        """Evaluate the telescope beam and map it onto ``data``'s grid."""
        return super().process(data, self._evaluate_beam(data))

    def _grid_coordinates(self, data):
        """(dec, ha) grid matching the data's (el, RA) sampling."""
        ha = (np.asarray(data.ra) + 180.0) % 360.0 - 180.0
        dec = (
            np.degrees(np.arcsin(np.asarray(data.index_map["el"])))
            + self.telescope.latitude
        )
        return dec, ha

    def _evaluate_beam(self, data):
        """Fill a celestial GridBeam from ``telescope.beam_at``."""
        dec, ha = self._grid_coordinates(data)
        out = containers.GridBeam(
            theta=dec,
            phi=ha,
            input=np.array(["common-mode"]),
            axes_from=data,
            attrs_from=data,
        )
        out.beam[:] = np.zeros(out.beam.shape, dtype=out.beam.dtype)
        out.weight[:] = np.ones(out.weight.shape, dtype=out.weight.dtype)

        pol_pairs = [
            p.decode() if isinstance(p, bytes) else str(p)
            for p in out.index_map["pol"]
        ]
        tel_pol = list(self.telescope.polarisation)

        # Nearest telescope frequency channel per data channel, flagged
        # invalid when it falls outside the channel width.
        fmap = data.index_map["freq"]
        centres = fmap["centre"] if fmap.dtype.names else np.asarray(fmap)
        widths = (
            fmap["width"]
            if fmap.dtype.names
            else np.full(len(centres), np.abs(np.diff(centres)).mean())
        )
        tel_freq = self.telescope.frequencies
        nearest = np.argmin(
            np.abs(centres[:, None] - tel_freq[None, :]), axis=1
        )
        in_band = np.abs(centres - tel_freq[nearest]) <= 0.5 * widths

        # One angular-position list covering the whole grid
        grid_shape = (dec.size, ha.size)
        theta_g, phi_g = np.meshgrid(
            0.5 * np.pi - np.radians(dec), np.radians(ha), indexing="ij"
        )
        angpos = np.stack([theta_g.ravel(), phi_g.ravel()], axis=-1)

        beam = np.asarray(out.beam[:])
        weight = np.asarray(out.weight[:])

        for ff, tel_ff in enumerate(nearest):
            if not in_band[ff]:
                weight[ff] = 0.0
                continue

            cache = {}

            def feed_beam(pol_char, _tf=tel_ff, _cache=cache):
                if pol_char not in _cache:
                    _cache[pol_char] = np.asarray(
                        self.telescope.beam_at(
                            tel_pol.index(pol_char), _tf, angpos
                        )
                    )
                return _cache[pol_char]

            for pp, pair in enumerate(pol_pairs):
                power = feed_beam(pair[0]) * feed_beam(pair[1]).conj()
                if power.ndim == 2:
                    # polarised (E_theta, E_phi) response: total intensity
                    power = power.sum(axis=-1)
                beam[ff, pp, 0] = power.reshape(grid_shape)

        out.beam[:] = beam
        out.weight[:] = weight
        return out
