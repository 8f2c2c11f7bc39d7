"""FFT ring-map making for cartesian arrays.

Re-provides reference ``draco/analysis/ringmapmaker.py`` (MakeVisGrid:38,
BeamformNS:186, BeamformEW:356, RingMapMaker:534, DeconvolveHybridMBase:538,
DeconvolveAnalyticalBeam:968, TikhonovRingMapMaker:1075,
WienerRingMapMaker:1123, RADependentWeights:1202,
ReconstructVisNoiseBase:1318, ReconstructVisWeight:1517,
ReconstructVisFreqCov:1604, find_grid_indices:1745).

Device design: the per-frequency NS phase matmul loop (reference
ringmapmaker.py:300-351) becomes one batched einsum over (pol, freq, ew),
the EW stage one batched irfft, the m-mode deconvolution one batched
einsum over all (m, pol, freq, el), and the freq-freq covariance
Cholesky one identity-padded batched device factorisation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask, group_tasks
from ..ops.tools import (
    as_device,
    calculate_redundancy,
    device_to_numpy,
    invert_no_zero,
    window_generalised,
)
from .transform import TelescopeStreamMixIn

C_LIGHT = 299792458.0


def _ew_weighting(scheme, template, exclude_cyl=()):
    """Unnormalised per-EW-column weights, broadcastable over ``template``.

    ``template`` is an array whose ``-2`` axis indexes EW separation.
    ``scheme = "inverse_variance"`` returns (a copy of) the template
    itself; ``"uniform"`` equal weights; ``"natural"`` a linear fall-off
    with cylinder separation.  Columns listed in ``exclude_cyl`` are
    zeroed.  Shared by the deconvolving map makers and the RA-dependence
    reconstruction (reference ringmapmaker.py:1094-1121,1252-1270).
    """
    if scheme == "inverse_variance":
        w = np.array(template, dtype=float, copy=True)
    else:
        n_ew = template.shape[-2]
        col = (
            np.ones(n_ew)
            if scheme == "uniform"
            else (n_ew - np.arange(n_ew)).astype(float)
        )
        shape = [1] * template.ndim
        shape[-2] = n_ew
        w = col.reshape(shape).copy()
    for cyl in exclude_cyl:
        w[..., cyl, :] = 0.0
    return w


def _sum_normalised(w, axis=-2):
    """Normalise weights to unit sum along ``axis`` (zero-safe)."""
    return w * np.asarray(invert_no_zero(np.sum(w, axis=axis, keepdims=True)))


def _ns_fft_axis(ny, min_ysep):
    """NS positions in FFT ordering for an ny-point grid."""
    return np.fft.fftfreq(ny, d=1.0 / (ny * min_ysep))


def find_basis(baselines):
    """Unit vectors of the (mostly-X, mostly-Y) grid axes.

    (reference ringmapmaker.py:1715-1742)
    """
    baselines = np.asarray(baselines)
    norms = np.einsum("ij,ij->i", baselines, baselines)
    shortest = int(np.argmin(np.where(norms == 0, 1e30, norms)))

    first = baselines[shortest]
    perp = np.array([first[1], -first[0]])
    xh, yh = (first, perp) if abs(first[0]) > abs(perp[0]) else (perp, first)

    def unit(v, component):
        direction = np.sign(v[component]) or 1.0
        return direction * v / np.linalg.norm(v)

    return unit(xh, 0), unit(yh, 1)


def find_grid_indices(baselines):
    """Integer grid indices and minimum separations of a cartesian layout.

    (reference ringmapmaker.py:1745)
    """
    baselines = np.asarray(baselines)

    def _indices(sep):
        nonzero = np.abs(sep[np.abs(sep) > 1e-6])
        minsep = nonzero.min() if nonzero.size else 1.0
        return np.rint(sep / minsep).astype(int), minsep

    xind, min_xsep = _indices(baselines[:, 0])
    yind, min_ysep = _indices(baselines[:, 1])
    return xind, yind, min_xsep, min_ysep


class MakeVisGrid(ContainerTask):
    """Scatter stacked visibilities onto a pol x EW x NS grid.

    (reference ringmapmaker.py:38-183)
    """

    centered = config.bool_prop(False)
    save_redundancy = config.bool_prop(True)

    def setup(self, tel):
        self.telescope = io.get_telescope(tel)

    def process(self, sstream):
        tel = self.telescope
        table = sstream.prodstack
        if not np.array_equal(
            np.stack([table["input_a"], table["input_b"]], axis=-1),
            tel.uniquepairs,
        ):
            raise ValueError(
                "The stream's product table differs from the beam-transfer one."
            )

        # polarisation label of every unique pair, and its slot on the
        # output pol axis; the conjugate-slot map handles intracylinder
        # mirror products below
        feedpol = np.asarray(tel.polarisation)[tel.uniquepairs]
        pol, pind = np.unique(
            np.char.add(feedpol[:, 0], feedpol[:, 1]), return_inverse=True
        )
        if len(pol) != 4:
            raise RuntimeError(
                f"Four polarisation products are required; the input has {pol}"
            )
        pconjmap = np.unique([b + a for a, b in pol], return_inverse=True)[1]

        xind, yind, min_xsep, min_ysep = find_grid_indices(tel.baselines)
        half_ns = np.abs(yind).max()
        ny = 2 * half_ns + 1
        vis_pos_x = np.arange(np.abs(xind).max() + 1) * min_xsep
        if self.centered:
            vis_pos_y = np.arange(-half_ns, half_ns + 1) * min_ysep
            ns_offset = half_ns
        else:
            vis_pos_y = _ns_fft_axis(ny, min_ysep)
            ns_offset = 0

        if "ra" in sstream.index_map:
            ra = sstream.ra
        elif "lsd" in sstream.attrs:
            ra = 360 * (tel.unix_to_lsd(sstream.time) - sstream.attrs["lsd"])
        else:
            ra = tel.lsa(sstream.time)

        grid = containers.VisGridStream(
            pol=pol, ew=vis_pos_x, ns=vis_pos_y, ra=ra,
            axes_from=sstream, attrs_from=sstream,
        )

        if self.save_redundancy:
            redundancy = np.asarray(
                calculate_redundancy(
                    np.asarray(sstream.input_flags[:]),
                    sstream.index_map["prod"][:],
                    sstream.reverse_map["stack"]["stack"][:],
                    sstream.vis.shape[1],
                )
            )
            grid.add_dataset("redundancy")

        ssv = np.asarray(sstream.vis[:])
        ssw = np.asarray(sstream.weight[:])

        # Vectorised scatter onto the grid.  Intracylinder (x == 0)
        # products ALSO land at the mirrored NS position under the
        # conjugate polarisation, so the scatter runs over an index list
        # extended with those mirror entries.
        # mirrors go first so measured products always win a collision
        intra = np.flatnonzero(xind == 0)
        s_vis = np.arange(len(pind))  # source product index
        scatter = [
            (pconjmap[pind[intra]], xind[intra], ns_offset - yind[intra], intra, True),
            (pind, xind, ns_offset + yind, s_vis, False),
        ]

        def place(dataset, source, freq_axis):
            """dataset axes [pol, (freq,), ew, ns, ...]; scatter source rows."""
            buf = np.zeros(dataset.shape, dtype=dataset.dtype)
            # move the grid axes in front of freq for one fancy assignment
            view = np.moveaxis(buf, (0, 2, 3), (0, 1, 2)) if freq_axis else buf
            for p, x, y, src, conj in scatter:
                rows = source[:, src] if freq_axis else source[src]
                rows = np.moveaxis(rows, 0, 1) if freq_axis else rows
                view[p, x, y] = np.conj(rows) if conj else rows
            dataset[:] = buf

        place(grid.vis, ssv, freq_axis=True)
        # weights and redundancy are real: the mirror conj is a no-op
        place(grid.weight, ssw, freq_axis=True)
        if self.save_redundancy:
            place(grid.datasets["redundancy"], redundancy, freq_axis=False)
        return grid


class BeamformNS(ContainerTask):
    """Beamform in the NS direction onto an elevation grid.

    (reference ringmapmaker.py:186-353): per-frequency phase matmuls over
    the NS axis, here a single batched device einsum over (pol, freq, ew).
    """

    npix = config.int_prop(512)
    span = config.float_prop(1.0)
    weight = config.str_prop("natural")
    scaled = config.bool_prop(False)
    include_auto = config.bool_prop(False)
    save_dirty_beam = config.bool_prop(False)
    precision = config.enum([32, 64], default=64)

    def process(self, gstream):
        gstream.redistribute("freq")
        # complex data moves as float pairs, combined inside the jit
        vis_host = np.asarray(gstream.vis[:])  # [pol, f, ew, ns, ra]
        gsv_re = jnp.asarray(np.ascontiguousarray(vis_host.real))
        gsv_im = jnp.asarray(np.ascontiguousarray(vis_host.imag))
        gsw = jnp.asarray(np.asarray(gstream.weight[:]))

        el = self.span * np.linspace(-1.0, 1.0, self.npix)
        hv = containers.HybridVisStream(el=el, axes_from=gstream, attrs_from=gstream)
        if self.save_dirty_beam:
            hv.add_dataset("dirty_beam")

        nspos = gstream.index_map["ns"][:]
        freq = gstream.freq
        iwv = (freq * 1e6) / C_LIGHT  # [f]

        baselines_present = np.any(np.asarray(gsw) > 0, axis=(0, 1, 2, 4))
        nsmax = (
            np.abs(nspos[baselines_present]).max()
            if baselines_present.sum() > 0
            else 0.0
        )
        self.log.info(f"Longest NS separation: {nsmax:.2f} m")

        hv.attrs.update(
            beamform_ns_weight=self.weight,
            beamform_ns_scaled=self.scaled,
            beamform_ns_include_auto=self.include_auto,
            beamform_ns_freqmin=freq.min(),
            beamform_ns_nsmax=nsmax,
        )

        cdtype = jnp.complex64 if self.precision == 32 else jnp.complex128
        rdtype = jnp.float32 if self.precision == 32 else jnp.float64

        # Weights per (pol, f, ew, ns, ra)
        if self.weight == "inverse_variance":
            gw = gsw.astype(rdtype)
        elif self.weight == "natural":
            if "redundancy" not in gstream.datasets:
                raise RuntimeError(
                    "Must set save_redundancy = True for task MakeVisGrid in "
                    "order to use a natural weight scheme."
                )
            gsr = jnp.asarray(
                np.asarray(gstream.datasets["redundancy"][:]), dtype=rdtype
            )
            gw = jnp.broadcast_to(gsr[:, None], vis_host.shape).astype(rdtype)
        else:
            vpos = nspos[np.newaxis, :] * iwv[:, np.newaxis]  # [f, ns]
            if self.scaled:
                vmax = nsmax * iwv.min()
            else:
                vmax = nsmax * iwv[:, np.newaxis]
            x = 0.5 * (vpos / vmax + 1)
            ns_weight = np.asarray(window_generalised(x, window=self.weight))
            gw = (gsw > 0) * jnp.asarray(ns_weight, dtype=rdtype)[
                None, :, None, :, None
            ]

        gw = gw * (gsw > 0)
        if not self.include_auto:
            gw = gw.at[..., 0, 0, :].set(0.0)

        norm = jnp.sum(gw, axis=-2)
        gw = gw * invert_no_zero(norm)[..., None, :]

        # Phase angles [el, ns] (real); the complex beamforming runs as
        # ONE jitted program, for fusion
        phase = 2.0 * np.pi * nspos[np.newaxis, :] * el[:, np.newaxis]
        hr, hi, hvb, t = _beamform_ns_core(
            gsv_re.astype(rdtype),
            gsv_im.astype(rdtype),
            gw,
            gsw.astype(rdtype),
            jnp.asarray(phase, dtype=rdtype),
            jnp.asarray(iwv, dtype=rdtype),
            save_dirty_beam=self.save_dirty_beam,
        )
        hv.vis[:] = (np.asarray(hr) + 1j * np.asarray(hi)).astype(
            hv.vis.dtype
        )

        if self.save_dirty_beam:
            hv.dirty_beam[:] = np.asarray(hvb).astype(np.float32)

        hv.weight[:] = np.asarray(t).astype(hv.weight.dtype)
        return hv


@functools.partial(jax.jit, static_argnames=("save_dirty_beam",))
def _beamform_ns_core(gsv_re, gsv_im, gw, gsw, phase, iwv, save_dirty_beam):
    """The NS phase beamforming as one fused device program.

    Jitted for op fusion.  Returns float planes
    (vis real, vis imag, dirty beam, weight).
    """
    rdt = gw.dtype
    cdt = jnp.complex64 if rdt == jnp.float32 else jnp.complex128
    ang = phase[None] * iwv[:, None, None]  # [f, el, ns]
    F = jax.lax.complex(jnp.cos(ang), -jnp.sin(ang)).astype(cdt)
    gvw = jax.lax.complex(gsv_re, gsv_im).astype(cdt) * gw
    hvv = jnp.einsum("fen,pfxnr->pfxer", F, gvw)
    if save_dirty_beam:
        hvb = jnp.einsum("fen,pfxnr->pfxer", F, gw.astype(cdt)).real
    else:
        hvb = jnp.zeros((), rdt)
    t = jnp.sum(invert_no_zero(gsw) * gw**2, axis=-2)
    return hvv.real, hvv.imag, hvb, invert_no_zero(t)


class BeamformEW(ContainerTask):
    """Final EW beamforming: pol rotation + irfft over EW.

    (reference ringmapmaker.py:356-531)
    """

    exclude_intracyl = config.bool_prop(False)
    single_beam = config.bool_prop(False)
    weight_ew = config.enum(["natural", "uniform"], default="natural")
    flag_ew = config.list_prop(None)

    @staticmethod
    def _get_pol(pols):
        """Output polarisations + rotation matrix (reference :500-531)."""
        have_cross = {"XY", "YX"} & set(pols)
        if len(have_cross) == 1:
            raise ValueError(
                f"Cross-polarisations must come as an XY/YX pair; found {pols}."
            )
        dpol = (["XX"] if "XX" in pols else []) + (
            ["reXY", "imXY"] if have_cross else []
        )
        if "YY" in pols:
            dpol.append("YY")

        # rotation: identity on co-pol rows, re/im split on the cross pair
        P = np.eye(len(dpol), dtype=np.complex64)
        if have_cross:
            i = dpol.index("reXY")
            P[i, i : i + 2] = [0.5, 0.5]
            P[i + 1, i : i + 2] = [-0.5j, 0.5j]
        return np.array(dpol, dtype="U4"), P

    def _ew_column_weights(self, n_ew):
        """Normalised per-EW-separation weights for the final transform."""
        w = (
            np.ones(n_ew)
            if self.weight_ew == "uniform"
            else n_ew - np.arange(n_ew, dtype=np.float64)
        )
        if self.exclude_intracyl:
            w[0] = 0.0
        if self.flag_ew is not None:
            if len(self.flag_ew) != n_ew:
                raise ValueError(
                    f"flag_ew has {len(self.flag_ew)} entries but the "
                    f"stream has {n_ew} EW separations."
                )
            w *= np.asarray(self.flag_ew, dtype=bool)
        if self.single_beam:
            # both fringe signs of every non-intracylinder column fold
            # into the single synthesized beam
            w[1:] *= 2
        return w / w.sum()

    def process(self, hstream):
        hstream.redistribute("freq")
        n_ew = len(hstream.index_map["ew"])
        nbeam = 1 if self.single_beam else 2 * n_ew - 1
        weight_ew = self._ew_column_weights(n_ew)

        pol, P = self._get_pol(
            [
                p.decode() if isinstance(p, bytes) else str(p)
                for p in hstream.index_map["pol"]
            ]
        )
        P2 = np.abs(P) ** 2

        save_dirty_beam = "dirty_beam" in hstream.datasets

        rm = containers.RingMap(
            beam=np.arange(nbeam), pol=pol, axes_from=hstream, attrs_from=hstream
        )
        rm.add_dataset("rms")
        if save_dirty_beam:
            rm.add_dataset("dirty_beam")

        vis_host = np.asarray(hstream.vis[:])  # [pol, f, ew, el, ra]
        hvb_host = (
            np.asarray(hstream.dirty_beam[:])
            if save_dirty_beam
            else np.zeros((), np.float64)
        )
        bf, rm_var, db = _beamform_ew_core(
            jnp.asarray(np.ascontiguousarray(vis_host.real)),
            jnp.asarray(np.ascontiguousarray(vis_host.imag)),
            jnp.asarray(np.asarray(hstream.weight[:])),
            jnp.asarray(np.ascontiguousarray(P.real)),
            jnp.asarray(np.ascontiguousarray(P.imag)),
            jnp.asarray(weight_ew),
            jnp.asarray(hvb_host),
            single_beam=self.single_beam,
            nbeam=nbeam,
            save_dirty_beam=save_dirty_beam,
        )
        # [pol, f, beam, el, ra] -> map axes [beam, pol, freq, ra, el]
        rm.map[:] = np.asarray(bf).astype(rm.map.dtype)
        rm_var = np.asarray(rm_var)
        rm.datasets["weight"][:] = (
            np.where(rm_var > 0, 1.0 / np.where(rm_var > 0, rm_var, 1.0), 0.0)[
                ..., None
            ]
            * np.ones((1, 1, 1, len(hstream.index_map["el"])))
        ).astype(np.float64)
        rm.datasets["rms"][:] = (rm_var**0.5).astype(np.float64)

        if save_dirty_beam:
            rm.dirty_beam[:] = np.asarray(db).astype(np.float64)

        return rm


@functools.partial(
    jax.jit, static_argnames=("single_beam", "nbeam", "save_dirty_beam")
)
def _beamform_ew_core(
    hv_re, hv_im, hvw, P_re, P_im, wew, hvb, single_beam, nbeam,
    save_dirty_beam,
):
    """EW pol-rotation + irfft as one fused device program (see
    _beamform_ns_core for why this must run under jit)."""
    Pj = jax.lax.complex(P_re, P_im)
    hvv = jax.lax.complex(hv_re, hv_im).astype(Pj.dtype)
    wew5 = wew[None, None, :, None, None]

    def form(x):
        v = jnp.tensordot(Pj, x, axes=(1, 0)) * wew5
        if single_beam:
            b = jnp.sum(v.real, axis=2)[:, :, None]  # [pol, f, 1, el, ra]
        else:
            b = jnp.fft.irfft(v, nbeam, axis=2) * nbeam
        # [pol, f, beam, el, ra] -> [beam, pol, freq, ra, el]
        return jnp.transpose(b, (2, 0, 1, 4, 3))

    bf = form(hvv)
    P2 = jnp.abs(Pj) ** 2
    var = jnp.tensordot(P2, invert_no_zero(hvw), axes=(1, 0))
    rm_var = 0.5 * jnp.sum(
        (wew**2)[None, None, :, None] * var, axis=2
    )  # [pol, f, ra]
    db = form(hvb.astype(Pj.dtype)) if save_dirty_beam else jnp.zeros((), hvw.dtype)
    return bf, rm_var, db



class RingMapMaker(group_tasks(MakeVisGrid, BeamformNS, BeamformEW)):
    """Make a ringmap from a sidereal stream (reference ringmapmaker.py:534)."""



@functools.partial(
    jax.jit, static_argnames=("skip_deconvolution", "nra", "iref")
)
def _deconvolve_core(
    hv_re, hv_im, bv_re, bv_im, jw, inv_var, jwin, eps,
    skip_deconvolution, nra, iref,
):
    """The m-space deconvolution as one fused device program."""
    jb = jax.lax.complex(bv_re, bv_im)
    jh = jax.lax.complex(hv_re, hv_im)
    nm = hv_re.shape[0]

    # Sum over (msign, ew) -> [m, pol, freq, el]
    sum_weight = jnp.sum(jw * jnp.abs(jb) ** 2, axis=(1, -2))
    if skip_deconvolution:
        C_inv = jnp.ones_like(sum_weight)
    else:
        C_inv = eps + sum_weight
    inv_C = invert_no_zero(C_inv)

    map_m = jwin * jnp.sum(jb.conj() * jw * jh, axis=(1, -2)) * inv_C
    dirty_beam_m = jwin * sum_weight * inv_C

    # Normalisation: dirty beam at transit; [pol, freq, el]
    norm = invert_no_zero(jnp.mean(dirty_beam_m, axis=0))
    if skip_deconvolution:
        norm = norm[:, :, iref, jnp.newaxis]

    def to_ra(x):
        # [m, pol, freq, el] -> [pol, freq, ra, el]
        xr = jnp.fft.irfft(jnp.moveaxis(x, 0, -1), axis=-1, n=nra)
        return jnp.moveaxis(xr, -1, 2)

    map_ra = to_ra(map_m) * norm[:, :, jnp.newaxis, :]
    dirty_beam_ra = to_ra(dirty_beam_m) * norm[:, :, jnp.newaxis, :]
    db_power = jnp.sum(dirty_beam_ra**2, axis=2) / nra

    # Noise propagation (reference ringmapmaker.py:801-823): ordering
    # chosen to avoid overflow as the NS beam drops to zero
    var = invert_no_zero(inv_var)
    sigma = jnp.sqrt(jnp.sum((jw * jnp.abs(jb)) ** 2 * var, axis=(1, -2)))
    sum_var_map_m = 0.5 * jnp.sum(
        (
            sigma
            * jwin
            * norm[jnp.newaxis, :, :, :]
            * invert_no_zero(nm * C_inv)
        )
        ** 2,
        axis=0,
    )  # [pol, freq, el]
    return map_ra, db_power, dirty_beam_ra, invert_no_zero(sum_var_map_m)


class DeconvolveHybridMBase(ContainerTask):
    """Base class for deconvolving ringmap makers (reference ringmapmaker.py:538).

    Device restructuring: the reference loops over frequencies on the host
    (ringmapmaker.py:741-823); here the deconvolution, normalisation,
    dirty-beam and noise propagation run as batched einsums over ALL
    (m, pol, freq, el) at once, with one batched irfft back to RA.

    Attributes
    ----------
    exclude_cyl : list of int
        Cylinder separations to exclude (0 = intracylinder, ...).
    exclude_intracyl : bool
        Deprecated alias for ``exclude_cyl = [0]``.
    skip_deconvolution : bool
        Skip the transfer-function deconvolution.
    reference_declination : float
        Flux normalisation declination when skipping deconvolution.
    save_dirty_beam : bool
        Store the EW synthesized beam per declination.
    window_type, window_size, window_scaled
        Optional window shaping the EW synthesized beam.
    """

    exclude_cyl = config.list_type(int, maxlength=3, default=[])
    exclude_intracyl = config.bool_prop(False)
    skip_deconvolution = config.bool_prop(False)
    reference_declination = config.float_prop(None)
    save_dirty_beam = config.bool_prop(False)

    window_type = config.enum(
        [
            "none", "uniform", "hann", "hanning", "hamming", "blackman",
            "nuttall", "blackman_nuttall", "blackman_harris",
        ],
        default="none",
    )
    window_size = config.float_prop(1.0)
    window_scaled = config.bool_prop(False)

    def setup(self, manager=None):
        """Set the telescope instance (needed for windows / normalisation)."""
        self.telescope = None if manager is None else io.get_telescope(manager)
        if self.telescope is None and self.window_type != "none":
            raise RuntimeError(
                "Applying a window requires a product manager at setup."
            )

        dropped = set(self.exclude_cyl)
        if self.exclude_intracyl:
            dropped.add(0)
        self.exclude_cyl = sorted(dropped)

    def process(self, hybrid_vis_m, hybrid_beam_m):
        """Deconvolve the beam m-modes from the visibility m-modes."""
        for axis, get in [
            ("freq", lambda c: np.asarray(c.freq)),
            ("el", lambda c: np.asarray(c.index_map["el"])),
            ("ew", lambda c: np.asarray(c.index_map["ew"])),
            ("pol", lambda c: np.asarray(c.index_map["pol"])),
        ]:
            if not np.array_equal(get(hybrid_vis_m), get(hybrid_beam_m)):
                raise ValueError(
                    f"{axis} does not match for beam and visibilities."
                )
        if hybrid_vis_m.mmax > hybrid_beam_m.mmax:
            raise ValueError(
                "The beam model's m range is too small for these visibilities"
            )

        freq = np.asarray(hybrid_vis_m.freq)
        m = np.asarray(hybrid_vis_m.index_map["m"])
        mmax = hybrid_vis_m.mmax
        nra = 2 * mmax + int(hybrid_vis_m.oddra)

        rm = containers.RingMap(
            beam=1, ra=nra, axes_from=hybrid_vis_m, attrs_from=hybrid_vis_m
        )
        rm.add_dataset("dirty_beam_power")
        if self.save_dirty_beam:
            rm.add_dataset("dirty_beam")

        rm.attrs["exclude_cyl"] = self.exclude_cyl
        if hasattr(self, "weight_ew"):
            rm.attrs["weight_ew"] = self.weight_ew

        nfreq = freq.size

        # Window over (freq, m, el), expanded to broadcast over pol
        if self.window_type != "none":
            window = self._get_window(hybrid_vis_m)  # [nfreq, nm, nel]
            # -> [nm, 1(pol), nfreq, nel]
            win = np.moveaxis(window, 0, 1)[:, np.newaxis, :, :]
        else:
            win = np.ones((1, 1, nfreq, 1), dtype=np.float32)

        if self.skip_deconvolution:
            el = np.asarray(rm.index_map["el"])
            if self.reference_declination is None:
                iref = int(np.argmin(np.abs(el)))
                self.log.info("Map normalisation referenced to zenith.")
            else:
                dec = np.degrees(np.arcsin(el)) + self.telescope.latitude
                iref = int(np.argmin(np.abs(dec - self.reference_declination)))
                self.log.info(
                    f"Map normalisation referenced to declination {dec[iref]:0.2f} deg."
                )

        # [m, msign, pol, freq, ew, el]
        hv = np.asarray(hybrid_vis_m.vis[:])
        hw = np.asarray(hybrid_vis_m.weight[:])
        bv = np.asarray(hybrid_beam_m.vis[:])[: (mmax + 1)]

        inv_var = hw[..., np.newaxis].copy()  # [m, msign, pol, freq, ew, 1]
        weight = np.asarray(self._get_weight(inv_var)) * (inv_var > 0.0)

        if not self.skip_deconvolution:
            # [nm, 1(pol), nfreq, 1(el)]
            eps = np.stack(
                [
                    np.broadcast_to(
                        np.asarray(self._get_regularisation(f, m), dtype=float),
                        (m.size, 1, 1),
                    )
                    for f in freq
                ],
                axis=2,
            )
        else:
            eps = np.zeros((1, 1, 1, 1))
            # iref only exists on the skip path
        map_ra, db_power, dirty_beam_ra, weight_out = _deconvolve_core(
            jnp.asarray(np.ascontiguousarray(hv.real)),
            jnp.asarray(np.ascontiguousarray(hv.imag)),
            jnp.asarray(np.ascontiguousarray(bv.real)),
            jnp.asarray(np.ascontiguousarray(bv.imag)),
            jnp.asarray(np.broadcast_to(weight, hv.shape).copy()),
            jnp.asarray(inv_var),
            jnp.asarray(win),
            jnp.asarray(eps),
            skip_deconvolution=self.skip_deconvolution,
            nra=int(nra),
            iref=int(iref) if self.skip_deconvolution else 0,
        )

        rm.map[:] = np.asarray(map_ra)[np.newaxis].astype(rm.map.dtype)
        rm.dirty_beam_power[:] = np.asarray(db_power)[np.newaxis].astype(
            rm.dirty_beam_power.dtype
        )
        if self.save_dirty_beam:
            rm.dirty_beam[:] = np.asarray(dirty_beam_ra)[np.newaxis].astype(
                rm.dirty_beam.dtype
            )
        rm.weight[:] = np.asarray(weight_out)[:, :, np.newaxis, :] * np.ones(
            (1, 1, nra, 1)
        )

        return rm

    def _get_window(self, hybrid_vis_m):
        """EW-sensitivity window over (freq, m, el) (reference :827-923)."""
        msg = "scaled" if self.window_scaled else "fixed-width"
        self.log.info(
            f"NS apodisation: {self.window_type} window, frequency-{msg}, "
            f"relative width {self.window_size}."
        )

        freq = np.asarray(hybrid_vis_m.freq)
        m = np.asarray(hybrid_vis_m.index_map["m"])
        el = np.asarray(hybrid_vis_m.index_map["el"])

        ew = np.array(
            [
                x
                for i, x in enumerate(np.asarray(hybrid_vis_m.index_map["ew"]))
                if i not in self.exclude_cyl
            ]
        )

        nlocal = freq.size

        dec = np.arcsin(el[np.newaxis, :]) + np.radians(self.telescope.latitude)
        lmbda = C_LIGHT / (freq[:, np.newaxis] * 1e6)

        ews = np.sort(np.abs(ew))
        # pad the band edge by half the outermost column spacing
        pad = 0.5 * (ews[-1] - ews[-2]) if len(ews) > 1 else 0.5 * max(ews[-1], 1.0)
        hi_ew = ews[-1] + pad
        positive = ews[ews > 0.0]
        lo_ew = 0.5 * positive[0] if np.min(ews) > 0.0 else -hi_ew

        centre_ew = 0.5 * (lo_ew + hi_ew)
        half_band = 0.5 * self.window_size * (hi_ew - lo_ew)

        ew_to_m = 2.0 * np.pi * np.abs(np.cos(dec)) / lmbda
        min_m = ew_to_m * (centre_ew - half_band)
        max_m = ew_to_m * (centre_ew + half_band)

        if self.window_scaled:
            min_m = np.max(min_m, axis=0, keepdims=True)
            max_m = np.min(max_m, axis=0, keepdims=True)

        # Evaluate the window over the whole (freq, m, el) block at once:
        # normalised coordinate u in [0, 1] inside the band, zero outside.
        lo = min_m[:, np.newaxis, :]  # [freq, 1, el]
        hi = max_m[:, np.newaxis, :]
        mm = m[np.newaxis, :, np.newaxis].astype(float)
        span = hi - lo
        u = np.clip((mm - lo) * np.asarray(invert_no_zero(span)), 0.0, 1.0)
        inside = (mm >= lo) & (mm <= hi)
        window = (
            np.asarray(window_generalised(u, window=self.window_type)) * inside
        ).astype(np.float32)

        if self.window_scaled:
            window = np.repeat(window, nlocal, axis=0)

        return window

    def _get_weight(self, inv_var):
        """EW-baseline averaging weights (subclass responsibility)."""
        raise NotImplementedError(
            f"{self.__class__} is abstract: implement _get_weight."
        )

    def _get_regularisation(self, freq, m):
        """Deconvolution regulariser (subclass responsibility)."""
        raise NotImplementedError(
            f"{self.__class__} is abstract: implement _get_regularisation."
        )


class DeconvolveAnalyticalBeam(DeconvolveHybridMBase):
    """Deconvolve an analytic (driftscan-style) beam model.

    (reference ringmapmaker.py:968-1072)
    """

    telescope = None

    def setup(self, telescope):
        """Set the telescope object (base-class cylinder exclusion)."""
        super().setup(telescope)

    def process(self, hybrid_vis_m):
        """Compute the analytic beam m-modes, then deconvolve."""
        hybrid_beam_m = self._get_beam_mmodes(hybrid_vis_m)
        return super().process(hybrid_vis_m, hybrid_beam_m)

    #: EW voltage beam width prefactors per feed polarisation, in
    #: MHz-degrees-of-sigma units (CHIME-like fits)
    _EW_SIGMA_PREFACTOR = {"X": 14.87857614, "Y": 9.95746878}

    def _get_beam_mmodes(self, hybrid_vis_m):
        from ..ops import mmode as mmode_ops

        mmax = hybrid_vis_m.mmax
        nra = 2 * mmax + int(hybrid_vis_m.oddra)
        freqs = np.asarray(hybrid_vis_m.freq)
        ewpos = np.asarray(hybrid_vis_m.index_map["ew"])
        dec = np.arcsin(np.asarray(hybrid_vis_m.index_map["el"])) + np.radians(
            self.telescope.latitude
        )
        pol = [
            p.decode() if isinstance(p, bytes) else str(p)
            for p in hybrid_vis_m.index_map["pol"]
        ]

        # Per-(pol, freq, el) Gaussian width: the product pair's sigmas
        # combine as sig_a sig_b / sqrt(sig_a^2 + sig_b^2)
        base = np.array(
            [[self._EW_SIGMA_PREFACTOR[c] for c in p] for p in pol]
        )  # [pol, 2]
        per_fd = 1.0 / (freqs[:, None] * np.cos(dec)[None, :])  # [freq, el]
        sa, sb = (
            base[:, i, None, None] * per_fd[None] for i in (0, 1)
        )  # each [pol, freq, el]
        sigma = sa * sb / np.hypot(sa, sb)

        phi = np.radians(np.linspace(0.0, 360.0, nra, endpoint=False))
        taper_arg = -0.5 * (2 * np.tan(phi / 2)) ** 2  # [ra]
        u = ewpos[None, :] * (freqs[:, None] * 1e6 / C_LIGHT)  # [freq, ew]

        hybrid_beam_m = containers.empty_like(hybrid_vis_m)
        bvis = np.zeros(hybrid_beam_m.vis.shape, dtype=np.complex64)

        # beam[p, f, x, e, r] = EW fringe at projected baseline
        # u cos(dec) times a Gaussian envelope in tan(phi/2); batched in
        # frequency chunks to bound the transient f64 footprint
        step = max(1, int(np.ceil(8 / max(len(pol), 1))))
        for f0 in range(0, freqs.size, step):
            fs = slice(f0, min(f0 + step, freqs.size))
            envelope = np.exp(
                taper_arg / sigma[:, fs, None, :, None] ** 2
            )  # [pol, f, 1, el, ra]
            fringe = np.exp(
                2.0j
                * np.pi
                * u[fs, :, None, None]
                * np.cos(dec)[None, None, :, None]
                * np.sin(phi)
            )  # [f, ew, el, ra]
            beam = fringe[None] * envelope  # [pol, f, ew, el, ra]
            bvis[:, :, :, fs] = device_to_numpy(
                mmode_ops.make_marray_device(
                    as_device(np.conj(beam)), mmax=mmax
                )
            )  # -> [m, msign, pol, f, ew, el]

        hybrid_beam_m.vis[:] = bvis
        return hybrid_beam_m


class TikhonovRingMapMaker(DeconvolveHybridMBase):
    """Tikhonov-regularised deconvolving map maker.

    (reference ringmapmaker.py:1075)

    Attributes
    ----------
    weight_ew : "natural" | "uniform" | "inverse_variance"
        EW baseline weighting.
    inv_SN : float
        Regularisation parameter.
    """

    weight_ew = config.enum(
        ["natural", "uniform", "inverse_variance"], default="natural"
    )
    inv_SN = config.float_prop(1e-6)

    def _get_weight(self, inv_var):
        return _sum_normalised(
            _ew_weighting(self.weight_ew, inv_var, self.exclude_cyl)
        )

    def _get_regularisation(self, *args):
        return self.inv_SN


class WienerRingMapMaker(DeconvolveHybridMBase):
    """Wiener-regularised deconvolving map maker.

    (reference ringmapmaker.py:1123).  The regulariser is the inverse of a
    power-law prior for galactic + point source emission.

    Attributes
    ----------
    gal_amp, gal_alpha, gal_beta : float
        Galactic synchrotron m-mode prior (amplitude, freq and m slopes).
    psrc_amp, psrc_alpha : float
        Point source prior.
    """

    gal_amp = config.float_prop(1.41)
    gal_alpha = config.float_prop(-1.75)
    gal_beta = config.float_prop(-0.75)

    psrc_amp = config.float_prop(0.045)
    psrc_alpha = config.float_prop(-1.0)

    pivot_freq = 600.0
    weight_ew = "inverse_variance"

    def _get_regularisation(self, freq, m, *args):
        nu = freq / self.pivot_freq
        m_slope = np.where(m > 0.0, m, 1.0) ** self.gal_beta
        gal = self.gal_amp * nu**self.gal_alpha * m_slope
        psrc = self.psrc_amp * nu**self.psrc_alpha
        prior = gal**2 + psrc**2
        return np.asarray(invert_no_zero(prior[:, np.newaxis, np.newaxis]))

    def _get_weight(self, inv_var):
        return _ew_weighting("inverse_variance", inv_var, self.exclude_cyl)


class TikhonovRingMapMakerAnalytical(DeconvolveAnalyticalBeam, TikhonovRingMapMaker):
    """Tikhonov deconvolution of the analytical beam model."""


class WienerRingMapMakerAnalytical(DeconvolveAnalyticalBeam, WienerRingMapMaker):
    """Wiener deconvolution of the analytical beam model."""


# Aliases to support old names
TikhonovRingMapMakerExternal = TikhonovRingMapMaker
WienerRingMapMakerExternal = WienerRingMapMaker


class RADependentWeights(ContainerTask):
    """Restore the RA dependence of deconvolved ring-map weights.

    (reference ringmapmaker.py:1202).  The m-mode round trip loses the RA
    dependence of the noise; it is reconstructed from the hybrid
    visibility weights.
    """

    def process(self, hybrid_vis, ringmap):
        """Scale the ringmap weights by the hybrid weights' RA dependence."""
        exclude_cyl = ringmap.attrs.get("exclude_cyl", None)
        weight_scheme = ringmap.attrs.get("weight_ew", None)

        if (exclude_cyl is None) or (weight_scheme is None):
            raise RuntimeError(
                "Reconstructing the noise RA dependence needs the ring-map "
                "maker's `weight_ew`/`exclude_cyl` settings stored in the "
                "container attributes; they are missing here."
            )

        save_filter = False
        for dset in ["filter", "complex_filter"]:
            if dset in hybrid_vis.datasets:
                ringmap.add_dataset(dset)
                ringmap[dset][:] = np.zeros(
                    ringmap[dset].shape, dtype=ringmap[dset].dtype
                )
                save_filter = True

        save_cov = False
        if weight_scheme != "inverse_variance":
            for dset in ["freq_cov", "complex_freq_cov"]:
                if dset in hybrid_vis.datasets:
                    ringmap.add_dataset(dset)
                    ringmap[dset][:] = np.zeros(
                        ringmap[dset].shape, dtype=ringmap[dset].dtype
                    )
                    save_cov = True

        var = np.asarray(invert_no_zero(np.asarray(hybrid_vis.weight[:])))
        var_time_avg = np.mean(var, axis=-1, keepdims=True)

        weight_ew = _ew_weighting(
            weight_scheme,
            np.asarray(invert_no_zero(var_time_avg))
            if weight_scheme == "inverse_variance"
            else var,
            exclude_cyl,
        )

        ra_dependence = np.sum(
            weight_ew**2 * var_time_avg, axis=-2
        ) * np.asarray(invert_no_zero(np.sum(weight_ew**2 * var, axis=-2)))

        ringmap.weight[:] = (
            np.asarray(ringmap.weight[:]) * ra_dependence[..., np.newaxis]
        ).astype(ringmap.weight.dtype)

        if save_filter:
            filt = np.asarray(hybrid_vis.filter[:])
            wew = _sum_normalised(weight_ew)[:, :, np.newaxis]
            ringmap.filter[:] = np.sum(wew * filt, axis=-2).astype(
                ringmap.filter.dtype
            )

        if save_cov:
            cov = np.asarray(hybrid_vis.freq_cov[:])
            wew = np.squeeze(weight_ew)
            wew2 = wew[:, np.newaxis] ** 2 * np.asarray(
                invert_no_zero(np.sum(wew) ** 2)
            )
            ringmap.freq_cov[:] = np.sum(wew2 * cov, axis=-2).astype(
                ringmap.freq_cov.dtype
            )

        return ringmap


class ReconstructVisNoiseBase(TelescopeStreamMixIn, ContainerTask):
    """Base for reconstructing visibility noise statistics.

    (reference ringmapmaker.py:1318).  Reproduces the statistical
    properties of hybrid beamformed visibilities — weights or freq-freq
    covariance — from the baseline layout and beamforming window.
    """

    def process(self, hv):
        """Build the noise-statistics container for ``hv``."""
        self._parse_attrs(hv.attrs)
        freq = self._redistribute_input(hv)
        layout = self._compute_layout(hv)
        window = self._compute_window(freq, layout)
        return self._fill_output(hv, window, layout)

    def _parse_attrs(self, attrs):
        for name in ("weight", "scaled", "include_auto", "freqmin", "nsmax"):
            setattr(self, name, attrs[f"beamform_ns_{name}"])
        if self.weight == "inverse_variance":
            raise ValueError(
                "The inverse_variance weighting mode has no RA "
                "reconstruction."
            )
        self.wvmin = C_LIGHT * 1e-6 / self.freqmin

    def _compute_layout(self, hv):
        """Baseline grid layout + redundancy (reference :1375-1463)."""
        tel = self.telescope
        out_pol = [
            p.decode() if isinstance(p, bytes) else str(p)
            for p in hv.index_map["pol"]
        ]
        npol = len(out_pol)

        # map each unique pair's polarisation product onto the output
        # pol axis; pairs whose product isn't in the output get -1
        pair_pols = tel.polarisation[tel.uniquepairs]
        labels, inverse = np.unique(
            np.char.add(pair_pols[:, 0], pair_pols[:, 1]), return_inverse=True
        )
        slot = {name: i for i, name in enumerate(out_pol)}
        pol_of_pair = np.array([slot.get(p, -1) for p in labels[inverse]])

        xind, yind, min_xsep, min_ysep = find_grid_indices(tel.baselines)
        ns_extent = np.abs(yind) * min_ysep
        within_ns = ns_extent <= self.nsmax + 0.5 * min_ysep

        ny = 2 * np.abs(yind).max() + 1
        nspos = _ns_fft_axis(ny, min_ysep)

        ewpos = np.asarray(hv.index_map["ew"])
        nx = ewpos.size
        full_x = np.arange(np.abs(xind).max() + 1) * min_xsep
        if not np.allclose(full_x, ewpos):
            raise RuntimeError("A truncated ew axis cannot be processed here.")

        keep = (pol_of_pair >= 0) & within_ns
        xind, yind, pind = xind[keep], yind[keep], pol_of_pair[keep]

        pconjmap = np.unique(
            [p[1] + p[0] for p in out_pol], return_inverse=True
        )[1]

        input_flags = np.all(tel.feedmask, axis=-1, keepdims=True)
        nbaseline = np.asarray(
            calculate_redundancy(
                input_flags.astype(np.float32),
                np.stack(
                    [self.bt_prod["input_a"], self.bt_prod["input_b"]], axis=-1
                ),
                self.bt_rev["stack"],
                len(self.bt_stack),
            )
        )[:, 0]
        kept_counts = nbaseline[keep]

        counts_grid = np.zeros((npol, nx, ny), dtype=float)
        counts_grid[pind, np.abs(xind), yind] = kept_counts
        intra = np.flatnonzero(xind == 0)
        counts_grid[pconjmap[pind[intra]], 0, -yind[intra]] = kept_counts[intra]

        return dict(
            xind=xind,
            yind=yind,
            pind=pind,
            ewpos=ewpos,
            nspos=nspos,
            nbaseline_grid=counts_grid,
            nbaseline=nbaseline,
            flag=keep,
            pconjmap=pconjmap,
            npol=npol,
            nx=nx,
            ny=ny,
        )

    def _compute_window(self, freq, layout):
        """Normalised NS beamforming window (reference :1465-1506)."""
        nfreq = freq.size
        window = np.empty(
            (layout["npol"], nfreq, layout["nx"], layout["ny"]), dtype=float
        )

        if self.weight == "natural":
            window[:] = layout["nbaseline_grid"][:, np.newaxis]
        else:
            # [nfreq, ny] fringe coordinates in wavelengths, folded into
            # the window's [0, 1] argument; broadcast over (pol, ew)
            per_wv = freq * 1e6 / C_LIGHT
            vpos = layout["nspos"][np.newaxis, :] * per_wv[:, np.newaxis]
            vmax = self.nsmax * (
                (1.0 / self.wvmin) if self.scaled else per_wv[:, np.newaxis]
            )
            arg = 0.5 * (vpos / vmax + 1)
            window[:] = np.asarray(
                window_generalised(arg, window=self.weight)
            )[np.newaxis, :, np.newaxis, :]

        if not self.include_auto:
            # match BeamformNS: the (ew=0, ns=0) auto sample is EXCLUDED
            # unless include_auto is set — the reconstructed window must
            # mirror the weights the beamformer actually applied.
            # (Deliberate deviation: the reference's reconstructor has
            # the condition inverted relative to its own beamformer,
            # ringmapmaker.py:1501 vs :330.)
            window[:, :, 0, 0] = 0.0

        norm = np.sum(window, axis=-1, keepdims=True)
        return window * np.asarray(invert_no_zero(norm))

    def _redistribute_input(self, hv):
        raise NotImplementedError(
            "abstract: subclasses define _redistribute_input."
        )

    def _fill_output(self, hv, window, layout):
        raise NotImplementedError("abstract: subclasses define _fill_output.")


class ReconstructVisWeight(ReconstructVisNoiseBase):
    """SiderealStream weights reproducing hybrid beamformed weights.

    (reference ringmapmaker.py:1517).  Output visibilities are zero; the
    weights beamform back to the input container's weights.
    """

    def _redistribute_input(self, hv):
        return np.asarray(hv.freq)

    def _fill_output(self, hv, window, layout):
        ss = containers.SiderealStream(
            axes_from=hv,
            attrs_from=hv,
            input=self.telescope.input_index,
            prod=self.bt_prod,
            stack=self.bt_stack,
            reverse_map_stack=self.bt_rev,
        )
        ss.vis[:] = np.zeros(ss.vis.shape, dtype=ss.vis.dtype)

        noise_factor = np.sum(
            window**2
            * np.asarray(
                invert_no_zero(layout["nbaseline_grid"][:, np.newaxis])
            ),
            axis=-1,
        )

        w0 = np.asarray(hv.weight[:]) * noise_factor[..., np.newaxis]

        wss = np.where(layout["flag"], layout["nbaseline"], 0.0)[
            np.newaxis, :, np.newaxis
        ] * np.ones(ss.weight.shape)

        for ff in range(w0.shape[1]):
            wss[ff][layout["flag"]] *= w0[
                layout["pind"], ff, np.abs(layout["xind"]), :
            ]

        ss.weight[:] = wss.astype(ss.weight.dtype)
        return ss


class ReconstructVisFreqCov(ReconstructVisNoiseBase):
    """Cholesky factors of the freq-freq covariance per (pol, ew, ra).

    (reference ringmapmaker.py:1604).  The per-(pol, ew, ra) masked
    Cholesky loop becomes one batched device ``jnp.linalg.cholesky`` with
    identity padding on masked channels.
    """

    def _redistribute_input(self, hv):
        return np.asarray(hv.freq)

    def _fill_output(self, hv, window, layout):
        out = containers.FreqNoiseModel(
            axes_from=hv, attrs_from=hv, ns=layout["nspos"]
        )

        dataset_name = (
            "complex_freq_cov"
            if "complex_freq_cov" in hv.datasets
            else "freq_cov"
        )
        out.add_dataset(dataset_name)

        out.redundancy[:] = layout["nbaseline_grid"].astype(
            out.redundancy.dtype
        )

        inv_nb = np.asarray(
            invert_no_zero(layout["nbaseline_grid"][:, np.newaxis])
        )

        cov_in = np.asarray(hv.freq_cov[:])  # [pol, freq, freq_sum, ew, ra]
        flag = np.asarray(hv.weight[:]) > 0.0  # [pol, freq, ew, ra]

        npol, nfreq, _, new, nra = cov_in.shape

        # Noise factor (pol, freq, freq_sum, ew)
        noise_factor = np.einsum(
            "pfxn,pgxn->pfgx", window * np.sqrt(inv_nb), window * np.sqrt(inv_nb)
        )
        inv_noise_factor = np.asarray(invert_no_zero(noise_factor))

        # Normalised covariances, batched: [pol, ew, ra, freq, freq]
        C_all = np.moveaxis(
            cov_in * inv_noise_factor[..., np.newaxis], (1, 2), (-2, -1)
        )
        M = np.moveaxis(flag, 1, -1).astype(C_all.real.dtype)  # [pol, ew, ra, f]
        M2 = M[..., :, None] * M[..., None, :]

        eye = np.eye(nfreq)
        B = C_all * M2 + eye * (1.0 - M[..., None, :] * eye)
        L = device_to_numpy(jnp.linalg.cholesky(as_device(B))) * M2

        out.freq_cov[:] = L.astype(out.freq_cov.dtype)

        diag = np.einsum("...ii->...i", C_all) * M  # [pol, ew, ra, f]
        weight_out = np.asarray(invert_no_zero(diag))
        out.weight[:] = np.moveaxis(weight_out, -1, 1).astype(
            out.weight.dtype
        )

        return out
