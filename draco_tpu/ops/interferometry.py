"""Interferometry helpers: fringestop phases.

Re-provides reference ``draco/util/interferometry.py`` (fringestop_phase:15)
plus the projected-distance geometry it pulls from caput.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def projected_distance(ha, lat, dec, u, v, w=0.0):
    """Baseline distance projected towards a source, in wavelengths.

    All angles in radians; (u, v, w) = (EW, NS, up) baseline components of
    (d_i - d_j) / lambda.  Arguments broadcast together.
    """
    xp = jnp if any(isinstance(a, jnp.ndarray) for a in (ha, u, v)) else np
    sinh, cosh_ = xp.sin(ha), xp.cos(ha)
    sind, cosd = xp.sin(dec), xp.cos(dec)
    sinl, cosl = xp.sin(lat), xp.cos(lat)
    return (
        u * cosd * sinh
        + v * (cosl * sind - sinl * cosd * cosh_)
        + w * (sinl * sind + cosl * cosd * cosh_)
    )


def fringestop_phase(ha, lat, dec, u, v, w=0.0):
    """Phase that *corrects* the fringing for a source at (ha, dec).

    (reference interferometry.py:15-44)
    """
    xp = jnp if any(isinstance(a, jnp.ndarray) for a in (ha, u, v)) else np
    return xp.exp(-2.0j * np.pi * projected_distance(ha, lat, dec, u, v, w))


def beamform_kernel(vis, sumweight, dec, lat, cosha, sinha, u, v):
    """Fringestop + weighted product sum: the beamforming hot loop.

    Batched device replacement for the Cython ``beamform``
    (reference draco/util/_fast_tools.pyx:211): for each (freq, ha),
    sum over products of weight * Re(vis * fringestop_phase).

    Parameters
    ----------
    vis : [nfreq, nha, nprod] complex
    sumweight : [nfreq, nha, nprod] real
    dec, lat : float (radians)
    cosha, sinha : [nha]
    u, v : [nfreq, nprod] baseline components in wavelengths

    Returns
    -------
    formed : [nfreq, nha] real (unnormalised weighted sum)
    """
    # One jitted, all-real program — with phase = exp(-2 pi i d),
    # Re(vis * phase) = Re(vis) cos(2 pi d) + Im(vis) sin(2 pi d).
    vis = np.asarray(vis)
    return _beamform_kernel_jit(
        jnp.asarray(np.ascontiguousarray(vis.real)),
        jnp.asarray(np.ascontiguousarray(vis.imag)),
        jnp.asarray(np.asarray(sumweight)),
        jnp.asarray(np.asarray(cosha)),
        jnp.asarray(np.asarray(sinha)),
        jnp.asarray(np.asarray(u)),
        jnp.asarray(np.asarray(v)),
        jnp.asarray(np.sin(dec)),
        jnp.asarray(np.cos(dec)),
        jnp.asarray(np.sin(lat)),
        jnp.asarray(np.cos(lat)),
    )


@jax.jit
def _beamform_kernel_jit(
    vr, vi, sumweight, cosha, sinha, u, v, sind, cosd, sinl, cosl
):
    # distance[f, h, p] = u c_d sH + v (cL sd - sL cd cH)
    dist = (
        u[:, None, :] * (cosd * sinha)[None, :, None]
        + v[:, None, :]
        * (cosl * sind - sinl * cosd * cosha)[None, :, None]
    )
    ang = 2.0 * np.pi * dist
    return jnp.sum(
        sumweight * (vr * jnp.cos(ang) + vi * jnp.sin(ang)), axis=-1
    )


def beamform_sources_batched(
    vis,
    sumweight,
    visweight,
    ra_idx,
    cosha,
    sinha,
    sind,
    cosd,
    lat,
    u,
    v,
    primary_beam,
    inverse_variance: bool,
):
    """Beamform a BATCH of sources in one device program (collapse-HA).

    The reference (and :func:`beamform_kernel`) advance one source per
    call; at catalog scale that is nsource host->device dispatches plus
    per-source host slicing.  Here the per-source RA windows gather on
    device and every (source, freq, ha, product) contraction runs as one
    batched program.

    Parameters
    ----------
    vis : [nfreq, nra, nprod] complex (device-resident)
    sumweight, visweight : [nfreq, nra, nprod] real
    ra_idx : [S, nha] int32 RA indices of each source's window
    cosha, sinha : [S, nha]
    sind, cosd : [S] sin/cos of each source declination
    lat : float (radians)
    u, v : [nfreq, nprod] baseline components in wavelengths
    primary_beam : [S, nfreq, nha] beam power at each source track
    inverse_variance : bool
        Weight mode: True returns the summed weight as the output
        weight; False propagates sw^2 / vw.

    Returns
    -------
    formed : [S, nfreq] beam-and-weight normalised flux
    weight : [S, nfreq] output weights (before the factor-2 real-part
        variance correction)
    """
    return _beamform_sources_jit(
        jnp.asarray(vis),
        jnp.asarray(sumweight),
        jnp.asarray(visweight),
        jnp.asarray(ra_idx),
        jnp.asarray(cosha),
        jnp.asarray(sinha),
        jnp.asarray(sind),
        jnp.asarray(cosd),
        jnp.asarray(float(lat)),
        jnp.asarray(u),
        jnp.asarray(v),
        jnp.asarray(primary_beam),
        inv_var=bool(inverse_variance),
    )


import functools as _functools

import jax as _jax


@_functools.partial(_jax.jit, static_argnames=("inv_var",))
def _beamform_sources_jit(
    vis, sw, vw, ra_idx, cosha, sinha, sind, cosd, lat, u, v, pb, *, inv_var
):
    from .tools import invert_no_zero

    S, nha = ra_idx.shape
    nfreq = vis.shape[0]
    flat = ra_idx.reshape(-1)
    vis_g = jnp.take(vis, flat, axis=1).reshape(nfreq, S, nha, -1)
    sw_g = jnp.take(sw, flat, axis=1).reshape(nfreq, S, nha, -1)
    sinl, cosl = jnp.sin(lat), jnp.cos(lat)
    # dist[f, s, h, p] = u cd sH + v (cL sd - sL cd cH)
    a = cosd[:, None] * sinha  # [S, h]
    b = cosl * sind[:, None] - sinl * cosd[:, None] * cosha
    dist = (
        u[:, None, None, :] * a[None, :, :, None]
        + v[:, None, None, :] * b[None, :, :, None]
    )
    phase = jnp.exp(-2.0j * np.pi * dist)
    formed = jnp.sum(sw_g * (vis_g * phase).real, axis=-1)  # [f, S, h]
    pbT = pb.transpose(1, 0, 2)  # [f, S, h]
    sw_h = jnp.sum(sw_g, axis=-1)  # [f, S, h]
    sumw = jnp.sum(sw_h * pbT**2, axis=-1)  # [f, S]
    formed_full = jnp.sum(formed * pbT, axis=-1) * invert_no_zero(sumw)
    if inv_var:
        wout = sumw
    else:
        vw_g = jnp.take(vw, flat, axis=1).reshape(nfreq, S, nha, -1)
        w2 = jnp.sum(
            jnp.sum(sw_g**2 * invert_no_zero(vw_g), axis=-1) * pbT**2,
            axis=-1,
        )
        wout = sumw**2 * invert_no_zero(w2)
    return formed_full.T, wout.T  # [S, f]


def beamform_sources_batched_ha(
    vis,
    sumweight,
    visweight,
    ra_idx,
    cosha,
    sinha,
    sind,
    cosd,
    lat,
    u,
    v,
    ha_valid,
    inverse_variance: bool,
):
    """HA-resolved variant of :func:`beamform_sources_batched`.

    Returns the normalised formed beam and weights per hour-angle bin
    instead of collapsing the track; padded / edge-clipped window slots
    are zeroed through ``ha_valid``.

    Returns
    -------
    formed : [S, nfreq, nha]
    weight : [S, nfreq, nha]
    """
    return _beamform_sources_ha_jit(
        jnp.asarray(vis),
        jnp.asarray(sumweight),
        jnp.asarray(visweight),
        jnp.asarray(ra_idx),
        jnp.asarray(cosha),
        jnp.asarray(sinha),
        jnp.asarray(sind),
        jnp.asarray(cosd),
        jnp.asarray(float(lat)),
        jnp.asarray(u),
        jnp.asarray(v),
        jnp.asarray(ha_valid),
        inv_var=bool(inverse_variance),
    )


@_functools.partial(_jax.jit, static_argnames=("inv_var",))
def _beamform_sources_ha_jit(
    vis, sw, vw, ra_idx, cosha, sinha, sind, cosd, lat, u, v, ha_valid, *,
    inv_var
):
    from .tools import invert_no_zero

    S, nha = ra_idx.shape
    nfreq = vis.shape[0]
    flat = ra_idx.reshape(-1)
    vis_g = jnp.take(vis, flat, axis=1).reshape(nfreq, S, nha, -1)
    sw_g = jnp.take(sw, flat, axis=1).reshape(nfreq, S, nha, -1)
    sinl, cosl = jnp.sin(lat), jnp.cos(lat)
    a = cosd[:, None] * sinha
    b = cosl * sind[:, None] - sinl * cosd[:, None] * cosha
    dist = (
        u[:, None, None, :] * a[None, :, :, None]
        + v[:, None, None, :] * b[None, :, :, None]
    )
    phase = jnp.exp(-2.0j * np.pi * dist)
    formed = jnp.sum(sw_g * (vis_g * phase).real, axis=-1)  # [f, S, h]
    sumw = jnp.sum(sw_g, axis=-1)  # [f, S, h]
    valid = ha_valid[None]  # [1, S, h]
    formed_n = formed * invert_no_zero(sumw) * valid
    if inv_var:
        wout = sumw * valid
    else:
        vw_g = jnp.take(vw, flat, axis=1).reshape(nfreq, S, nha, -1)
        w2 = jnp.sum(sw_g**2 * invert_no_zero(vw_g), axis=-1)
        wout = sumw**2 * invert_no_zero(w2) * valid
    return formed_n.transpose(1, 0, 2), wout.transpose(1, 0, 2)
