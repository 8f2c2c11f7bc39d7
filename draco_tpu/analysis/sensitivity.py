"""System-sensitivity estimation, built as device einsums.

Re-designs reference ``draco/analysis/sensitivity.py``
(ComputeSystemSensitivity:11-261) for the device: the reference walks python
loops over polarisation groups and a double loop over autocorrelation
pairs; here each polarisation group is a row of a membership matrix and
the radiometric auto x auto outer product is a single
``einsum("pij,fit,fjt->fpt")`` contraction, so the whole estimate is one
jitted XLA program.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops import tools
from ..ops.tools import invert_no_zero


@jax.jit
def _measured_noise(member, scale, cnt_f, weight):
    """Inverse-variance ("measured") noise summed over each pol group.

    member : [npol, nstack] group membership (0/1)
    scale : [nstack] 2 for cross-pairs, 1 for autos
    cnt_f : [nfreq, nstack, ntime] redundancy counts
    weight : [nfreq, nstack, ntime] visibility weights
    """
    flag = (weight > 0.0).astype(cnt_f.dtype)
    contrib = cnt_f * scale[None, :, None] * flag
    var = jnp.einsum("ps,fst->fpt", member, contrib * cnt_f * invert_no_zero(weight))
    counter = jnp.einsum("ps,fst->fpt", member, contrib)
    return var * invert_no_zero(counter) ** 2, counter


@jax.jit
def _radiometer_noise(pair_member, nfeed, auto, nint):
    """Radiometric prediction from products of stacked autocorrelations.

    pair_member : [npol, nauto, nauto] pol-group membership of each
        auto pair (already excludes disallowed intracylinder pairs)
    nfeed : [nfreq, nauto, ntime] effective feed counts
    auto : [nfreq, nauto, ntime] real parts of the stacked autos
    nint : [nfreq, 1, ntime] integration samples (dnu * tint * (1 - lost))
    """
    x = nfeed * auto
    rad = jnp.einsum("pij,fit,fjt->fpt", pair_member, x, x)
    cnt = jnp.einsum("pij,fit,fjt->fpt", pair_member, nfeed, nfeed)
    return rad * invert_no_zero(nint * cnt**2)


class ComputeSystemSensitivity(ContainerTask):
    """Per-(freq, pol, time) noise estimates of stacked visibilities.

    Produces two estimates (reference sensitivity.py:11-261): the
    "measured" noise from the stored inverse-variance weights, and the
    "radiometer" prediction built from the autocorrelations via the
    radiometer equation.  Both are referenced to the real part of a
    polarisation-averaged visibility.

    Attributes
    ----------
    exclude_intracyl : bool
        Drop intracylinder baselines from both estimates.  Requires
        cylinder information to still be present in the stack.
    """

    exclude_intracyl = config.bool_prop(False)

    def setup(self, telescope):
        """Keep the telescope model used to classify inputs."""
        self.telescope = io.get_telescope(telescope)

    # -- host-side bookkeeping -------------------------------------------

    def _flag_patterns(self, data, nfreq, ntime):
        """Redundancy counts per stack for every (freq, time) sample.

        Input flags (optionally refined by the gain dataset) rarely
        change sample to sample, so counts are computed once per unique
        flag column and scattered back; returns ``[nstack, nfreq_eff,
        ntime]`` where ``nfreq_eff`` is 1 without per-frequency gain
        flags.
        """
        iflg = np.asarray(data.input_flags[:]).astype(bool)

        if "gain" in data.datasets:
            # gains exactly equal to one mark absent inputs
            gflg = np.asarray(data.datasets["gain"][:]) != (1.0 + 0.0j)
            cols = (iflg[np.newaxis] & gflg).transpose(1, 0, 2)
            cols = cols.reshape(cols.shape[0], nfreq * ntime)
            nfreq_eff = nfreq
        else:
            cols = iflg
            nfreq_eff = 1

        patterns, scatter = np.unique(cols, return_inverse=True, axis=1)
        cnt = tools.calculate_redundancy(
            patterns.astype(np.float32),
            np.asarray(data.prod),
            np.asarray(data.reverse_map["stack"]["stack"]),
            len(data.stack),
        )
        return cnt[:, scatter].reshape(-1, nfreq_eff, ntime)

    def _classify_stacks(self, data):
        """Per-stack (input_a, input_b), pol label and EW positions."""
        stack_new, stack_flag = tools.redefine_stack_index_map(
            self.telescope,
            data.input,
            data.prod,
            data.stack,
            data.reverse_map["stack"],
        )
        nbad = int(np.sum(~stack_flag))
        if nbad:
            self.log.warning(
                f"{nbad} stacks are flagged out by the telescope model; "
                "they still enter the sensitivity sums."
            )

        pairs = data.prod[stack_new["prod"]]
        flip = stack_new["conjugate"].astype(bool)
        in_a = np.where(flip, pairs["input_b"], pairs["input_a"])
        in_b = np.where(flip, pairs["input_a"], pairs["input_b"])

        tel_index = tools.find_inputs(
            self.telescope.input_index, data.input, require_match=False
        )
        pol_of_input = np.array(
            [
                "N" if ti is None else self.telescope.polarisation[ti]
                for ti in tel_index
            ]
        )
        ew_of_input = np.array(
            [
                0.0 if ti is None else self.telescope.feedpositions[ti, 0]
                for ti in tel_index
            ]
        )
        return in_a, in_b, pol_of_input, ew_of_input

    @staticmethod
    def _pol_label(pol_of_input, in_a, in_b):
        """Order-independent two-character pol label per stack."""
        pa, pb = pol_of_input[in_a], pol_of_input[in_b]
        lo = np.where(pa <= pb, pa, pb)
        hi = np.where(pa <= pb, pb, pa)
        return np.char.add(lo, hi)

    # -- the task --------------------------------------------------------

    def process(self, data):
        """Return a SystemSensitivity container for ``data``."""
        nfreq, nstack, ntime = data.vis.shape

        cnt = self._flag_patterns(data, nfreq, ntime)  # [nstack, nfe, ntime]
        in_a, in_b, pol_of_input, ew_of_input = self._classify_stacks(data)
        stack_pol = self._pol_label(pol_of_input, in_a, in_b)

        if self.exclude_intracyl and not hasattr(
            self.telescope, "cylinder_width"
        ):
            raise AttributeError(
                "exclude_intracyl requires a telescope with a "
                "cylinder_width attribute (the intracylinder separation "
                "threshold); silently assuming 0 would make the measured "
                "and radiometric estimates use different baseline sets."
            )
        half_cyl = 0.5 * getattr(self.telescope, "cylinder_width", 0.0)
        ew_sep = np.abs(ew_of_input[in_a] - ew_of_input[in_b])
        allowed = ew_sep > half_cyl if self.exclude_intracyl else np.ones(
            nstack, dtype=bool
        )

        pol_names = [p for p in np.unique(stack_pol) if "N" not in p]
        npol = len(pol_names)
        member = np.stack(
            [(stack_pol == p) & allowed for p in pol_names]
        ).astype(np.float32)

        is_auto = in_a == in_b
        if self.exclude_intracyl and int(is_auto.sum()) == npol:
            raise ValueError(
                "exclude_intracyl needs per-cylinder autos, but this "
                "stack retains only one auto per polarisation — the "
                "cylinder axis has already been collapsed."
            )

        # broadcast the unique-pattern counts onto the full freq axis
        nfe = cnt.shape[1]
        cnt_f = np.ascontiguousarray(
            np.moveaxis(cnt[:, np.arange(nfreq) % nfe], 1, 0)
        )  # [nfreq, nstack, ntime]

        scale = 2.0 - is_auto.astype(np.float32)  # both triangles for cross
        weight = np.asarray(data.weight[:]).astype(np.float32)

        var, counter = _measured_noise(
            jnp.asarray(member),
            jnp.asarray(scale),
            jnp.asarray(cnt_f.astype(np.float32)),
            jnp.asarray(weight),
        )

        # -- radiometric prediction --------------------------------------
        auto_idx = np.flatnonzero(is_auto)
        auto_input = in_a[auto_idx]
        auto_pol = pol_of_input[auto_input]
        nauto = auto_idx.size

        # pol-group membership of each (auto_i, auto_j) pair
        pi = np.broadcast_arrays(auto_pol[:, None], auto_pol[None, :])
        first = np.where(pi[0] <= pi[1], pi[0], pi[1])
        second = np.where(pi[0] <= pi[1], pi[1], pi[0])
        lbl = np.char.add(first, second)
        pair_member = np.stack([lbl == p for p in pol_names]).astype(np.float32)
        if self.exclude_intracyl:
            sep = np.abs(
                ew_of_input[auto_input][:, None]
                - ew_of_input[auto_input][None, :]
            )
            pair_member *= (sep >= half_cyl).astype(np.float32)[None]

        auto_vis = np.asarray(data.vis[:])[:, auto_idx, :].real.astype(np.float32)
        auto_flag = (weight[:, auto_idx, :] > 0.0).astype(np.float32)
        nfeed = cnt_f[:, auto_idx, :].astype(np.float32) * auto_flag

        tint = np.median(np.abs(np.diff(np.asarray(data.time))))
        fmap = data.index_map["freq"]
        dnu = (
            np.median(fmap["width"])
            if fmap.dtype.names
            else np.median(np.abs(np.diff(fmap)))
        ) * 1e6

        # a 'frac_lost' dataset (raw-data packet-loss fraction) is
        # honoured when present; the reference reads it from the raw
        # acquisition's flags group, which these containers don't model
        if "frac_lost" in data.datasets:
            frac_lost = np.asarray(data.datasets["frac_lost"][:])
        else:
            frac_lost = np.zeros((nfreq, ntime), dtype=np.float32)
        nint = (dnu * tint * (1.0 - frac_lost))[:, np.newaxis, :]

        radiometer = _radiometer_noise(
            jnp.asarray(pair_member),
            jnp.asarray(nfeed),
            jnp.asarray(auto_vis),
            jnp.asarray(nint.astype(np.float32)),
        )

        # -- package ------------------------------------------------------
        metrics = containers.SystemSensitivity(
            pol=np.array(pol_names, dtype="<U2"),
            axes_from=data,
            attrs_from=data,
        )
        # sqrt(2): quote the std-dev of the real component given that the
        # sums covered both visibility-matrix triangles
        metrics.radiometer[:] = np.sqrt(2.0 * np.asarray(radiometer))
        metrics.measured[:] = np.sqrt(2.0 * np.asarray(var))
        metrics.weight[:] = np.asarray(counter)
        metrics.frac_lost[:] = frac_lost.astype(np.float32)
        return metrics
