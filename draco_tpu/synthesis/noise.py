"""Add instrumental noise effects into simulations.

Re-provides reference ``draco/synthesis/noise.py`` (ReceiverTemperature:21,
GaussianNoiseDataset:48, MultipleNoiseRealizationsMixin:127, GaussianNoise:178,
SampleNoise:287, FreqCorrelatedNoise:377).

Device design: the SampleNoise per-(freq, time) complex-Wishart loop
(reference noise.py:344-372) becomes one batched Bartlett-decomposition
draw on the JAX PRNG; FreqCorrelatedNoise's per-(pol, ew) Cholesky
colouring loops become batched matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..ops import random as drandom
from ..ops import tools

# Ratio of an SI second to a sidereal second (caput STELLAR_S equivalent).
STELLAR_S = 86164.0905 / 86400.0


def _auto_mask(prodstack) -> np.ndarray:
    """Boolean mask of the auto-correlation entries of a prodstack."""
    return np.array([p[0] == p[1] for p in prodstack], dtype=bool)


def _time_interval(data) -> tuple[float, int]:
    if isinstance(data, containers.SiderealStream):
        ra = data.ra
        return 240 * (ra[1] - ra[0]) * STELLAR_S, len(ra)
    t = data.time
    if len(t) < 2:
        # single-sample windows (per-time-window disk streaming) cannot
        # derive the cadence from the axis; the producer declares it
        dt = data.attrs.get("integration_time")
        if dt is None:
            raise ValueError(
                "cannot infer the integration time from a length-"
                f"{len(t)} time axis; set attrs['integration_time'] "
                "(seconds) on the container"
            )
        return float(dt), len(t)
    return t[1] - t[0], len(t)


class ReceiverTemperature(ContainerTask):
    """Add a receiver temperature offset to the autos (reference noise.py:21)."""

    recv_temp = config.float_prop(0.0)

    def process(self, data):
        autos = _auto_mask(data.prodstack)
        vis = tools.as_device(np.asarray(data.vis[:]))
        vis = vis + self.recv_temp * jnp.asarray(autos)[None, :, None]
        data.vis[:] = tools.device_to_numpy(vis).astype(data.vis.dtype)
        return data


class GaussianNoiseDataset(ContainerTask, RandomTask):
    """Replace a dataset with noise drawn from its weights.

    (reference noise.py:48)
    """

    dataset = config.str_prop(None)
    in_place = config.bool_prop(True)

    def process(self, data):
        if self.dataset is None:
            if isinstance(data, containers.DataWeightContainer):
                dataset_name = data._data_dset_name
            else:
                raise ValueError(
                    f"Cannot pick a default dataset on {type(data)}."
                )
        else:
            dataset_name = self.dataset
        if dataset_name not in data:
            raise config.ConfigError(
                f"Dataset {dataset_name!r} does not exist in container "
                f"{type(data)}."
            )
        data.redistribute("freq")
        out = data if self.in_place else data.copy()

        dset = np.asarray(out[dataset_name][:])
        weight = jnp.asarray(np.asarray(data.weight[:]))
        std = tools.invert_no_zero(weight) ** 0.5
        key = self.next_key()
        if np.iscomplexobj(dset):
            noise = drandom.complex_normal(
                key, size=dset.shape, scale=1.0, dtype=jnp.complex64
            ) * std.astype(jnp.complex64)
        else:
            noise = jax.random.normal(key, dset.shape, dtype=jnp.float32) * std

        noise = tools.device_to_numpy(noise).astype(dset.dtype)
        # Autos are real with doubled variance (reference noise.py:117-122)
        if dataset_name == "vis":
            autos = _auto_mask(data.prodstack)
            noise[:, autos] = (np.sqrt(2) * noise[:, autos].real).astype(
                noise.dtype
            )
        out[dataset_name][:] = noise
        return out


class MultipleNoiseRealizationsMixin:
    """Generate multiple noise realizations (reference noise.py:127)."""

    niter = config.int_prop(1)
    in_place = False

    def setup(self, data1, data2=None):
        self.data = [data1]
        if data2 is not None:
            self.data.append(data2)

    def process(self):
        if self._count == self.niter:
            raise PipelineStopIteration()
        return super().process(self.data[self._count % len(self.data)])


class MultipleGaussianNoiseDatasets(
    MultipleNoiseRealizationsMixin, GaussianNoiseDataset
):
    """Multiple Gaussian noise datasets (reference noise.py:172)."""


class GaussianNoise(ContainerTask, RandomTask):
    """Add radiometer-equation Gaussian noise (reference noise.py:178).

    Attributes
    ----------
    recv_temp, ndays, set_weights, add_noise
        As in the reference: nsamp = ndays * dt * df * redundancy and
        std = recv_temp / sqrt(nsamp) (reference noise.py:260-261).
    """

    recv_temp = config.float_prop(50.0)
    ndays = config.float_prop(733.0)
    set_weights = config.bool_prop(True)
    add_noise = config.bool_prop(True)

    def setup(self, manager=None):
        self.telescope = io.get_telescope(manager) if manager is not None else None

    def process(self, data):
        data.redistribute("freq")
        dt, ntime = _time_interval(data)
        df = data.index_map["freq"]["width"][0] * 1e6
        nfreq = data.vis.shape[0]
        prodstack = data.prodstack
        nprod = len(prodstack)
        ninput = len(data.index_map["input"])

        if (self.telescope is not None) and (nprod == self.telescope.nbase):
            redundancy = self.telescope.redundancy
        elif nprod == ninput * (ninput + 1) // 2:
            redundancy = np.ones(nprod)
        else:
            raise ValueError("Product count does not match a full triangle")

        nsamp = int(self.ndays * dt * df) * redundancy
        std = self.recv_temp / np.sqrt(nsamp)

        if self.add_noise:
            key = self.next_key()
            noise = drandom.complex_normal(
                key, size=(nfreq, nprod, ntime), dtype=jnp.complex64
            ) * jnp.asarray(std[np.newaxis, :, np.newaxis], dtype=jnp.float32)
            autos = jnp.asarray(_auto_mask(prodstack))[None, :, None]
            vis = tools.as_device(np.asarray(data.vis[:]))
            # autos: add sqrt(2) * real part only (reference noise.py:271-277)
            vis = jnp.where(
                autos, vis + np.sqrt(2) * noise.real, vis + noise
            )
            data.vis[:] = tools.device_to_numpy(vis).astype(data.vis.dtype)

        if self.set_weights:
            w = (1.0 / std**2)[np.newaxis, :, np.newaxis]
            data.weight[:] = np.broadcast_to(
                w, data.weight.shape
            ).astype(data.weight.dtype)
        return data


def _wishart_chunk_kernel(nfeed: int):
    """Jitted Wishart chunk sampler (cached per feed count).

    One compiled program handles every chunk of the flattened
    (freq, time) batch: unpack the triangle to Hermitian matrices,
    regularise, Cholesky, draw a Bartlett standard-Wishart, colour it,
    and repack the upper triangle.  The input buffer is DONATED so the
    [B, nfeed, nfeed] working set recycles in place across chunks —
    the whole [nfreq, ntime, nfeed, nfeed] stack (33 MB per (f, t)
    sample at 2048 feeds) is never materialised.
    """
    kern = _WISHART_KERNELS.get(nfeed)
    if kern is not None:
        return kern

    iu = np.triu_indices(nfeed)

    def kernel(vis_ut, n_dof, key, idx):
        # vis_ut [B, nprod] complex; n_dof [B] float; idx [B] int32 —
        # the GLOBAL flat (freq, time) row index.  Each row's draw is
        # keyed by fold_in(key, global row), so the realisation for a
        # given seed is independent of the HBM-budget chunking
        # (round-4 advisor finding: per-chunk folding made the same
        # seed produce different noise under different
        # DRACO_TPU_SAMPLENOISE_CHUNK_GB / hardware).
        vm = tools.unpack_product_array(vis_ut, axis=1, nside=nfeed)
        # Regularise: the Cholesky needs strictly positive-definite
        # inputs, and a noiseless/rank-deficient expectation matrix is
        # only PSD — add a small diagonal scaled to the mean auto power
        diag_mean = jnp.einsum("...ii->...", vm.real) / nfeed
        eps = 1e-6 * jnp.maximum(diag_mean, 1e-30)[..., None, None]
        vm = vm + eps * jnp.eye(nfeed, dtype=vm.dtype)
        L = jnp.linalg.cholesky(vm)
        row_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
        A = jax.vmap(
            lambda k, nd: drandom.standard_complex_wishart(
                k, nfeed, nd, batch_shape=(), dtype=vm.dtype
            )
        )(row_keys, n_dof)
        samp = L @ A @ jnp.conj(jnp.swapaxes(L, -1, -2))
        samp = samp / n_dof[..., None, None].astype(samp.real.dtype)
        return samp[..., iu[0], iu[1]]  # [B, nprod]

    kernel = jax.jit(kernel, donate_argnums=(0,))
    _WISHART_KERNELS[nfeed] = kernel
    return kernel


_WISHART_KERNELS: dict = {}


class SampleNoise(ContainerTask, RandomTask):
    """Draw complex-Wishart distributed visibility samples.

    (reference noise.py:287-374): the expectation visibilities (full
    triangle) are unpacked into Hermitian matrices, a Wishart sample with
    nsamp degrees of freedom is drawn around each, and the triangle is
    repacked.  The (freq, time) draws STREAM through a fixed-size batched
    Bartlett kernel on device: the chunk size is picked so the Hermitian
    working set fits an HBM budget (``DRACO_TPU_SAMPLENOISE_CHUNK_GB``,
    default 2), which is what lets a 2048-feed CHIME-scale config run at
    all — the full unpacked stack would be ~33 MB per (freq, time)
    sample.

    Attributes
    ----------
    sample_frac : float
        Multiplies the number of samples in each measurement.
    set_weights : bool
        Set the weights appropriately afterwards.
    """

    sample_frac = config.float_prop(1.0)
    set_weights = config.bool_prop(True)

    def process(self, data_exp):
        import os

        data_exp.redistribute("freq")
        nfeed = len(data_exp.index_map["input"])
        vis_host = np.asarray(data_exp.vis[:])  # [nfreq, nprod, ntime]
        nfreq, nprod, ntime = vis_host.shape
        if nprod != nfeed * (nfeed + 1) // 2:
            raise ValueError("SampleNoise requires full-triangle visibilities.")

        dt, _ = _time_interval(data_exp)
        df = data_exp.index_map["freq"]["width"] * 1e6  # [nfreq]
        nsamp = (self.sample_frac * dt * df).astype(int)  # [nfreq]

        # Flatten (freq, time) into one batch axis and stream it in
        # fixed-size chunks: ~7 [B, nfeed, nfeed] complex buffers live
        # at once (unpacked, regularised, L, Bartlett T, A, two matmul
        # temps), so budget_bytes / (7 * 8 * nfeed^2) rows per chunk.
        budget = float(
            os.environ.get("DRACO_TPU_SAMPLENOISE_CHUNK_GB", "2")
        ) * 2**30
        n_total = nfreq * ntime
        chunk = max(1, min(n_total, int(budget // (7 * 8 * nfeed * nfeed))))

        flat = np.ascontiguousarray(
            np.moveaxis(vis_host, 2, 1).reshape(n_total, nprod)
        )
        ndof_flat = np.repeat(
            np.asarray(nsamp, dtype=np.float32), ntime
        )  # row i = (freq i//ntime, time i%ntime)

        kernel = _wishart_chunk_kernel(nfeed)
        key = self.next_key()
        out = np.empty_like(flat)
        for start in range(0, n_total, chunk):
            stop = min(start + chunk, n_total)
            buf = flat[start:stop]
            ndof = ndof_flat[start:stop]
            # per-row global indices: the draw for row i is
            # fold_in(key, i) regardless of how the stream is chunked
            idx = np.arange(start, start + chunk, dtype=np.int32)
            if stop - start < chunk:
                # pad to the compiled batch size; padded rows get a
                # safely-PD zero matrix and dof > nfeed (gamma shape
                # must stay positive), and are discarded below
                pad = chunk - (stop - start)
                buf = np.concatenate(
                    [buf, np.zeros((pad, nprod), buf.dtype)]
                )
                ndof = np.concatenate(
                    [ndof, np.full(pad, nfeed + 1, ndof.dtype)]
                )
            res = kernel(
                tools.as_device(buf),
                jnp.asarray(ndof),
                key,
                jnp.asarray(idx),
            )
            out[start:stop] = tools.device_to_numpy(res)[: stop - start]

        if not np.isfinite(out).all():
            # jnp.linalg.cholesky returns NaN instead of raising on a
            # non-PD matrix (the scipy path the reference uses raises
            # LinAlgError) — fail loudly rather than writing NaN
            raise RuntimeError(
                "SampleNoise: Cholesky of the expectation visibility "
                "matrix failed (non-positive-definite even after "
                "regularisation); check for flagged feeds or a "
                "rank-deficient sky model."
            )
        vis_new = np.ascontiguousarray(
            np.moveaxis(out.reshape(nfreq, ntime, nprod), 1, 2)
        )
        data_exp.vis[:] = vis_new.astype(data_exp.vis.dtype)

        if self.set_weights:
            autos = tools.extract_diagonal(vis_new, axis=1).real
            weight_fac = jnp.asarray(nsamp)[:, None, None] ** 0.5 * tools.invert_no_zero(
                autos
            )
            w = tools.apply_gain(
                jnp.asarray(np.asarray(data_exp.weight[:])),
                weight_fac,
                axis=1,
            )
            data_exp.weight[:] = np.asarray(w.real).astype(data_exp.weight.dtype)
        return data_exp


class FreqCorrelatedNoise(ContainerTask, RandomTask):
    """Frequency-correlated noise from Cholesky factors.

    (reference noise.py:377-470): colour unit normals with the stored
    freq-freq Cholesky factors; batched matmul over (pol, ew, ra).

    Attributes
    ----------
    save_redundancy : bool
        Save the redundancy of each visibility.
    """

    save_redundancy = config.bool_prop(False)

    def process(self, noise_model: containers.FreqNoiseModel):
        noise_model.redistribute("ra")
        out = containers.VisGridStream(
            axes_from=noise_model, attrs_from=noise_model
        )

        redundancy = np.asarray(noise_model.redundancy[:])  # [pol, ew, ns]
        inv_sqrt_red = tools.invert_no_zero(np.sqrt(redundancy))

        if self.save_redundancy:
            out.add_dataset("redundancy")
            out.datasets["redundancy"][:] = np.broadcast_to(
                redundancy[..., np.newaxis], out.datasets["redundancy"].shape
            ).astype(np.int32)

        L = tools.as_device(np.asarray(noise_model.freq_cov[:]))  # [p,e,ra,f,f]
        weight = np.asarray(noise_model.weight[:])  # [p, f, e, ra]

        npol, nfreq, new, nns, nra = out.vis.shape
        key = self.next_key()
        z = drandom.complex_normal(
            key, size=(npol, new, nra, nfreq, nns), dtype=jnp.complex64
        )
        sz = L.astype(z.dtype) @ z  # [p, e, ra, f, ns]
        # divide by sqrt(redundancy) per NS baseline
        sz = sz * jnp.asarray(
            inv_sqrt_red[:, :, None, None, :], dtype=jnp.float32
        )
        ovis = jnp.transpose(sz, (0, 3, 1, 4, 2))  # [p, f, e, ns, ra]

        # Hermitian fixup for the EW=0 plane (reference noise.py:456-468)
        nyp = nns // 2 + 1
        pol_names = [
            p.decode() if isinstance(p, bytes) else str(p)
            for p in out.index_map["pol"]
        ]
        pconjmap = np.unique(
            [p[1] + p[0] for p in pol_names], return_inverse=True
        )[1]
        ovis_np = tools.device_to_numpy(ovis)
        for pi, po in enumerate(pconjmap):
            ovis_np[po, :, 0, -1 : -nyp : -1, :] = ovis_np[
                pi, :, 0, 1:nyp, :
            ].conj()
            if pi == po:
                ovis_np[po, :, 0, 0, :] = ovis_np[pi, :, 0, 0, :].real * 2**0.5

        out.vis[:] = ovis_np.astype(out.vis.dtype)
        oweight = (
            weight[:, :, :, np.newaxis, :]
            * redundancy[:, np.newaxis, :, :, np.newaxis]
        )
        out.weight[:] = oweight.astype(out.weight.dtype)
        return out


class MultipleFreqCorrelatedNoise(MultipleNoiseRealizationsMixin, FreqCorrelatedNoise):
    """Multiple frequency-correlated noise realizations (reference noise.py:473)."""
