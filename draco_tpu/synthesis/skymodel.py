"""Gaussian sky models: the native `cora-makesky` equivalent.

The reference stack obtains its input sky maps from the external *cora*
package (``cora-makesky 21cm/synchrotron/...``, reference
doc/tutorial.rst:78-119), which draco then consumes through
``draco.core.io.LoadMaps`` (reference draco/core/io.py:10).  This module
re-provides that capability natively: frequency-correlated Gaussian
realisations of foreground and 21 cm angular power spectra, drawn with the
JAX PRNG and synthesised to HEALPix maps through the on-device SHT
(:mod:`draco_tpu.ops.sht`) — per-l frequency covariances are factorised
with one batched eigendecomposition and the alm draw is a single batched
matmul, instead of cora's per-l host loop.

Foreground spectra follow the Santos, Cooray & Knox (2005; astro-ph/0408515,
Table 1) parametrisation also used by cora::

    C_l(nu1, nu2) = A (l_ref/l)^alpha (nu_ref^2 / (nu1 nu2))^beta
                    exp(-log^2(nu1/nu2) / (2 xi^2))

with ``l_ref = 1000`` and ``nu_ref = 130 MHz``.  The 21 cm signal is a
phenomenological Gaussian field with a power-law angular spectrum and a
finite frequency correlation length — adequate as pipeline input where the
reference only requires *a* statistically reasonable signal map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..ops import sht as sht_ops

__all__ = [
    "FrequencyCorrelatedSky",
    "Synchrotron",
    "ExtragalacticPointSource",
    "ExtragalacticFreeFree",
    "GalacticFreeFree",
    "CombinedForeground",
    "Corr21cm",
    "gaussian_realisation_alm",
    "make_sky",
    "GenerateGaussianSky",
]


@functools.partial(jax.jit, static_argnames=("lmax",))
def _realisation_block(key, cl_blk, lmax):
    """Draw one l-chunk of frequency-correlated alm."""
    rdtype = cl_blk.dtype
    cdtype = jnp.complex128 if rdtype == jnp.float64 else jnp.complex64

    # Factor each C_l via eigh (robust to the rank-deficient fully
    # frequency-correlated limit where Cholesky fails)
    evals, evecs = jnp.linalg.eigh(cl_blk)
    fac = evecs * jnp.sqrt(jnp.clip(evals, 0.0, None))[..., None, :]

    nl, nfreq = cl_blk.shape[0], cl_blk.shape[1]
    kr, ki = jax.random.split(key)
    zr = jax.random.normal(kr, (nl, lmax + 1, nfreq), dtype=rdtype)
    zi = jax.random.normal(ki, (nl, lmax + 1, nfreq), dtype=rdtype)
    # m > 0: complex unit-variance; m = 0: real unit-variance
    z = (zr + 1j * zi) * jnp.sqrt(0.5).astype(rdtype)
    z = z.at[:, 0, :].set(zr[:, 0, :].astype(cdtype))
    # alm[f, l, m] = sum_g fac[l, f, g] z[l, m, g]
    return jnp.einsum("lfg,lmg->flm", fac.astype(cdtype), z)


def gaussian_realisation_alm(key, cl, lblock: int = 256, dtype=None):
    """Draw alm of a frequency-correlated Gaussian random field.

    Parameters
    ----------
    key : jax PRNG key
    cl : array [lmax+1, nfreq, nfreq]
        Angular cross-power spectra between frequencies.
    lblock : int
        l-chunk size bounding the memory of the batched eigh.
    dtype : real dtype of the factor (defaults to cl's dtype)

    Returns
    -------
    alm : complex array [nfreq, lmax+1, lmax+1]
        Dense (l, m) coefficients, m >= 0 (real-field convention of
        :mod:`draco_tpu.ops.sht`), with E[a_lm(nu1) a_lm(nu2)*] =
        C_l(nu1, nu2).
    """
    cl = jnp.asarray(cl)
    if dtype is not None:
        cl = cl.astype(dtype)
    lmax = cl.shape[0] - 1

    blocks = []
    for l0 in range(0, lmax + 1, lblock):
        l1 = min(l0 + lblock, lmax + 1)
        key, sub = jax.random.split(key)
        blocks.append(_realisation_block(sub, cl[l0:l1], lmax))
    alm = jnp.concatenate(blocks, axis=1)

    # Zero the unphysical m > l triangle
    ls = jnp.arange(lmax + 1)[:, None]
    ms = jnp.arange(lmax + 1)[None, :]
    return alm * (ms <= ls)


class FrequencyCorrelatedSky:
    """Base class: a Gaussian sky defined by C_l(nu1, nu2).

    Subclasses implement :meth:`angular_powerspectrum`.  The equivalent
    role in the reference stack is cora's ``Map3d``/foreground model
    classes behind ``cora-makesky``.
    """

    #: polarisation fraction for Q/U realisations (0 = unpolarised model)
    polarisation_fraction = 0.0
    #: frequency decorrelation (xi) used for the polarised component
    polarisation_xi = 0.5

    def angular_powerspectrum(self, l, nu1, nu2):
        """C_l(nu1, nu2) for broadcastable (l, nu1, nu2) in (MHz, K^2)."""
        raise NotImplementedError

    def _cl_table(self, lmax, freq):
        l = np.arange(lmax + 1)[:, None, None]
        nu1 = np.asarray(freq)[None, :, None]
        nu2 = np.asarray(freq)[None, None, :]
        return np.asarray(self.angular_powerspectrum(l, nu1, nu2))

    def generate_alm(self, lmax, freq, key, lblock: int = 256):
        """Draw Stokes-I alm at the given frequencies."""
        cl = self._cl_table(lmax, freq)
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        return gaussian_realisation_alm(
            key, jnp.asarray(cl, dtype=dtype), lblock=lblock
        )

    def generate_map(self, nside, freq, seed=0, pol: bool = False, lmax=None):
        """Synthesise maps [nfreq, npol, npix] (Stokes I, or IQUV)."""
        if lmax is None:
            lmax = 3 * nside - 1
        key = jax.random.PRNGKey(int(seed))
        ki, kq, ku = jax.random.split(key, 3)

        alm = self.generate_alm(lmax, freq, ki)[:, None]  # [f, 1, l, m]
        maps = sht_ops.sphtrans_inv_sky(alm, nside)  # [f, 1, npix]

        if not pol:
            return maps

        npix = maps.shape[-1]
        out = jnp.zeros((len(freq), 4, npix), dtype=maps.dtype)
        out = out.at[:, 0].set(maps[:, 0])
        fpol = float(self.polarisation_fraction)
        if fpol > 0.0:
            # Q/U: same spatial spectrum scaled by fpol^2, with a shorter
            # frequency coherence (Faraday decorrelation).  Composite models
            # (e.g. CombinedForeground) hold xi on their components, so the
            # swap must reach every object that carries one.
            targets = [self, *getattr(self, "components", [])]
            saved = [(t, t.xi) for t in targets if hasattr(t, "xi")]
            try:
                for t, _ in saved:
                    t.xi = self.polarisation_xi
                clp = self._cl_table(lmax, freq) * fpol**2
            finally:
                for t, old in saved:
                    t.xi = old
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
            clp = jnp.asarray(clp, dtype=dtype)
            for pi, kp in ((1, kq), (2, ku)):
                almp = gaussian_realisation_alm(kp, clp)[:, None]
                out = out.at[:, pi].set(
                    sht_ops.sphtrans_inv_sky(almp, nside)[:, 0]
                )
        return out


class _SCKForeground(FrequencyCorrelatedSky):
    """Santos-Cooray-Knox (2005) power-law foreground component."""

    #: amplitude at (l_ref, nu_ref) in K^2
    A = 0.0
    alpha = 1.0
    beta = 2.0
    xi = 1.0
    l_ref = 1000.0
    nu_ref = 130.0  # MHz

    def angular_powerspectrum(self, l, nu1, nu2):
        l = np.maximum(np.asarray(l, dtype=np.float64), 1.0)
        nu1 = np.asarray(nu1, dtype=np.float64)
        nu2 = np.asarray(nu2, dtype=np.float64)
        return (
            self.A
            * (self.l_ref / l) ** self.alpha
            * (self.nu_ref**2 / (nu1 * nu2)) ** self.beta
            * np.exp(-np.log(nu1 / nu2) ** 2 / (2 * self.xi**2))
        )


class Synchrotron(_SCKForeground):
    """Galactic synchrotron (SCK Table 1): the dominant foreground."""

    A = 700e-6  # 700 mK^2 -> K^2
    alpha = 2.4
    beta = 2.80
    xi = 4.0
    polarisation_fraction = 0.3
    polarisation_xi = 0.5


class ExtragalacticPointSource(_SCKForeground):
    """Unresolved extragalactic point-source background (SCK Table 1)."""

    A = 57e-6
    alpha = 1.1
    beta = 2.07
    xi = 1.0


class ExtragalacticFreeFree(_SCKForeground):
    """Extragalactic free-free emission (SCK Table 1)."""

    A = 0.014e-6
    alpha = 1.0
    beta = 2.10
    xi = 35.0


class GalacticFreeFree(_SCKForeground):
    """Galactic free-free emission (SCK Table 1)."""

    A = 0.088e-6
    alpha = 3.0
    beta = 2.15
    xi = 35.0


class CombinedForeground(FrequencyCorrelatedSky):
    """Sum of the four SCK components (the `cora-makesky foreground` sky)."""

    polarisation_fraction = 0.3
    polarisation_xi = 0.5

    def __init__(self):
        self.components = [
            Synchrotron(),
            ExtragalacticPointSource(),
            ExtragalacticFreeFree(),
            GalacticFreeFree(),
        ]

    def angular_powerspectrum(self, l, nu1, nu2):
        return sum(c.angular_powerspectrum(l, nu1, nu2) for c in self.components)


class Corr21cm(FrequencyCorrelatedSky):
    """Phenomenological Gaussian 21 cm signal.

    Mean brightness temperature T_b(z) = T21 * sqrt((1+z)/2.5) (the
    standard low-z scaling), a power-law angular spectrum, and a Gaussian
    frequency decorrelation of width ``corr_width`` MHz::

        C_l(nu1,nu2) = T_b(nu1) T_b(nu2) (l_ref/(l+1))^alpha
                       exp(-(nu1-nu2)^2 / (2 corr_width^2))
    """

    T21 = 0.3e-3  # K
    alpha = 1.0
    l_ref = 100.0
    corr_width = 0.5  # MHz
    NU21 = 1420.405751  # MHz

    def T_b(self, nu):
        z = self.NU21 / np.asarray(nu, dtype=np.float64) - 1.0
        return self.T21 * np.sqrt(np.maximum(1.0 + z, 0.0) / 2.5)

    def angular_powerspectrum(self, l, nu1, nu2):
        l = np.asarray(l, dtype=np.float64)
        return (
            self.T_b(nu1)
            * self.T_b(nu2)
            * (self.l_ref / (l + 1.0)) ** self.alpha
            * np.exp(-((nu1 - nu2) ** 2) / (2 * self.corr_width**2))
        )


_SKY_MODELS = {
    "synchrotron": Synchrotron,
    "pointsource": ExtragalacticPointSource,
    "freefree": ExtragalacticFreeFree,
    "galacticfreefree": GalacticFreeFree,
    "foreground": CombinedForeground,
    "21cm": Corr21cm,
}


def make_sky(
    model="foreground",
    nside: int = 64,
    freq=None,
    nfreq: int = 32,
    freq_start: float = 400.0,
    freq_end: float = 500.0,
    seed: int = 0,
    pol: bool = False,
    lmax=None,
):
    """Generate a sky :class:`~draco_tpu.core.containers.Map`.

    The native equivalent of the ``cora-makesky`` CLI the reference
    tutorial drives (reference doc/tutorial.rst:78-119).  ``model`` is a
    name from {synchrotron, pointsource, freefree, galacticfreefree,
    foreground, 21cm} or a :class:`FrequencyCorrelatedSky` instance.
    """
    if isinstance(model, str):
        try:
            model = _SKY_MODELS[model.lower()]()
        except KeyError:
            raise ValueError(
                f"Unknown sky model {model!r}; pick from {sorted(_SKY_MODELS)}"
            ) from None

    if freq is None:
        freq = np.linspace(freq_start, freq_end, nfreq, endpoint=False)
    freq = np.asarray(freq, dtype=np.float64)

    maps = model.generate_map(nside, freq, seed=seed, pol=pol, lmax=lmax)

    m = containers.Map(nside=nside, polarisation=bool(pol), freq=freq)
    m.map[:] = np.asarray(maps)
    m.attrs["tag"] = getattr(model, "tag", type(model).__name__.lower())
    return m


class GenerateGaussianSky(ContainerTask, RandomTask):
    """Pipeline task producing Gaussian sky maps (cora-makesky as a task).

    Attributes
    ----------
    model : str
        One of {synchrotron, pointsource, freefree, galacticfreefree,
        foreground, 21cm}.
    nside, freq_start, freq_end, nfreq, polarisation, lmax
        Map geometry and frequency sampling.
    num_realisations : int
        Number of maps to generate before stopping.
    """

    model = config.enum(sorted(_SKY_MODELS), default="foreground")
    nside = config.int_prop(64)
    freq_start = config.float_prop(400.0)
    freq_end = config.float_prop(500.0)
    nfreq = config.int_prop(32)
    polarisation = config.bool_prop(False)
    lmax = config.int_prop(None)
    num_realisations = config.int_prop(1)

    def setup(self):
        # a dedicated counter: ContainerTask.next() also advances
        # self._count per output, so reusing it halved the number of
        # realisations and skipped tag numbers
        self._nreal_done = 0

    def process(self):
        if self._nreal_done >= self.num_realisations:
            raise PipelineStopIteration
        self._nreal_done += 1
        seed = int(self.rng.integers(0, 2**31 - 1))
        m = make_sky(
            model=self.model,
            nside=self.nside,
            nfreq=self.nfreq,
            freq_start=self.freq_start,
            freq_end=self.freq_end,
            seed=seed,
            pol=self.polarisation,
            lmax=self.lmax,
        )
        m.attrs["tag"] = f"{self.model}_{self._nreal_done - 1}"
        return m
