"""Sharded detection + digest reduction over a JAX device mesh.

The counterpart of the reference's rayon data parallelism
(SURVEY.md §2.4): every message is independent (``README.md:10``), so

* clues are sharded over the ``data`` mesh axis (the reference shards over
  threads via ``par_iter``, ``examples/omr.rs:160-164``);
* the detection key (BSK1/KSK/BSK2/TraceKey) is replicated — it is read-only
  per message;
* digest accumulation is an exact modular sum, reduced across shards with
  ``jax.lax.psum`` — the collective replacing the rayon tree-reduce at
  reference ``detector.rs:333-336,445-449``.

Because the reduction is exact modular addition, sharded digests are
bit-identical to single-device digests (tested in tests/test_parallel.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# jax.shard_map is the stable API (>= 0.6); the jax.experimental import
# warns of removal. check_vma=False is the successor of check_rep=False.
shard_map = jax.shard_map

from tfhe_omr.core.detector import Detector
from tfhe_omr.core.sender import ClueBatch


def make_data_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """A 1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


class ShardedDetector:
    """Runs a Detector's programs under ``shard_map`` over a data mesh."""

    def __init__(self, detector: Detector, mesh: Mesh, axis_name: str = "data"):
        self.detector = detector
        self.mesh = mesh
        self.axis = axis_name
        self.n_dev = mesh.devices.size
        f2 = detector.ctx.f2
        self._multiproc = jax.process_count() > 1
        # replicate the (read-only) detection key across the mesh — the
        # counterpart of rayon threads sharing the key by reference. In a
        # multi-controller run every process derived the same key from the
        # same seed, so the global array is assembled from local host copies
        # (cross-host device transfers are not available on all backends).
        self.key = jax.tree_util.tree_map(self._replicate, detector.key)
        #: replicated device copies of the detector's precomputed tables
        #: (they ride the programs as arguments, as in
        #: Detector._build_programs)
        self.tables = jax.tree_util.tree_map(
            self._replicate, detector.tables
        )
        self._enc_cache = {}

        self._detect_sharded = jax.jit(
            shard_map(
                detector._detect_fn,
                mesh=mesh,
                in_specs=(P(axis_name), P(axis_name), P(), P()),
                out_specs=P(axis_name),
                check_vma=False,
            )
        )

        ntt2 = detector.ctx.ntt2

        def encode_shard(pert, plain):
            """Local MAC-sum then exact modular psum across shards."""
            pn = ntt2.fwd(plain.T)
            prod = f2.mul(pert.transpose(1, 2, 0), pn[None])
            local = f2.mod_sum(prod, axis=2)
            # psum of values < q over n_dev shards stays < n_dev * q < 2**62
            total = jax.lax.psum(local, axis_name)
            return f2.reduce(total, f2.bits + self.n_dev.bit_length() + 1)

        self._encode_sharded = jax.jit(
            shard_map(
                encode_shard,
                mesh=mesh,
                in_specs=(P(axis_name), P(axis_name)),
                out_specs=P(),
                check_vma=False,
            )
        )

    # ----------------------------------------------------------------- api
    def pad(self, count: int) -> int:
        """Messages per shard-aligned batch."""
        d = self.n_dev
        return -(-count // d) * d

    def _replicate(self, x):
        if x is None:
            return None
        sh = NamedSharding(self.mesh, P())
        if not self._multiproc:
            return jax.device_put(x, sh)
        xh = np.asarray(x)
        return jax.make_array_from_callback(xh.shape, sh, lambda idx: xh[idx])

    def _shard(self, x):
        sh = NamedSharding(self.mesh, P(self.axis))
        if not self._multiproc:
            return jax.device_put(jnp.asarray(x), sh)
        xh = np.asarray(x)
        return jax.make_array_from_callback(xh.shape, sh, lambda idx: xh[idx])

    def _shard_pert(self, pert):
        """Commit a pertinency stack to the data-axis sharding. Accepts a
        single-device array (resharded) or, in multi-controller runs, a
        global array already produced by ``detect``."""
        if self._multiproc:
            assert isinstance(pert, jax.Array) and len(pert.sharding.device_set) > 1, (
                "multi-process encoders need the global pertinency array "
                "from ShardedDetector.detect"
            )
            return pert
        return jax.device_put(
            jnp.asarray(pert), NamedSharding(self.mesh, P(self.axis))
        )

    def detect(self, clues: ClueBatch) -> jnp.ndarray:
        """Sharded batched detection. Ragged batches are zero-padded to a
        shard-aligned size and the padding rows sliced off (zero clues are
        valid ciphertexts, so padding only costs compute)."""
        bsz = clues.a.shape[0]
        padded = self.pad(bsz)
        a, b7 = clues.a, clues.b7
        if self._multiproc or not isinstance(a, jax.Array):
            # multi-controller global arrays are assembled from host copies
            a, b7 = np.asarray(a), np.asarray(b7)
            xp = np
        else:
            # device-resident clues stay on device: _shard resharding is a
            # device-to-device put, with no host round trip
            xp = jnp
        if padded != bsz:
            a = xp.concatenate(
                [a, xp.zeros((padded - bsz, a.shape[1]), a.dtype)]
            )
            b7 = xp.concatenate(
                [b7, xp.zeros((padded - bsz, b7.shape[1]), b7.dtype)]
            )
        out = self._detect_sharded(
            self._shard(a), self._shard(b7), self.key, self.tables
        )
        return out[:bsz] if padded != bsz else out

    def encode_chunk(self, pertinency, plain):
        """Digest chunk accumulation with psum reduce; returns (2, N2)."""
        return self._encode_sharded(
            self._shard(pertinency), self._shard(plain)
        )

    # ------------------------------------------------- full digest encoders
    def _idx_scan_fn(self, nd: int, segs: int, chunk: int):
        """Whole-digest sharded index encoder: ONE jitted shard_map program
        that scans chunk-sized blocks of the LOCAL pertinency shard and
        psums the per-shard partial sums once at the end (the collective
        replacing the rayon tree-reduce, reference detector.rs:333-336)."""
        key = ("idx", nd, segs, chunk)
        fn = self._enc_cache.get(key)
        if fn is not None:
            return fn
        from tfhe_omr.core.detector import index_poly_device

        det = self.detector
        f2 = det.ctx.f2
        ntt2 = det.ctx.ntt2
        idx_p = det.ctx.params.output_plain_modulus
        q2 = f2.q
        axis = self.axis
        nbits = f2.bits + self.n_dev.bit_length() + 1

        def encode(pert, base_addr, idx):
            t_loc = pert.shape[0]
            n2v = pert.shape[2]
            cl = min(chunk, t_loc)
            pad = (-t_loc) % cl
            if pad:
                pert = jnp.concatenate(
                    [pert, jnp.zeros((pad,) + pert.shape[1:], pert.dtype)]
                )
                base_addr = jnp.concatenate(
                    [base_addr, jnp.zeros((pad, segs), base_addr.dtype)]
                )
                idx = jnp.concatenate([idx, jnp.zeros((pad,), idx.dtype)])
            nc = pert.shape[0] // cl
            pr = pert.reshape((nc, cl) + pert.shape[1:])
            ba = base_addr.reshape(nc, cl, segs)
            ix = idx.reshape(nc, cl)

            def body(acc, xs):
                p, b, i = xs
                poly = index_poly_device(b, i, nd, segs, n2v, idx_p, q2)
                pn = ntt2.fwd(poly.T)
                prod = f2.mul(p.transpose(1, 2, 0), pn[None])
                return f2.add(acc, f2.mod_sum(prod, axis=2)), None

            acc0 = jnp.zeros((2, n2v), dtype=jnp.int64)
            local, _ = jax.lax.scan(body, acc0, (pr, ba, ix))
            return f2.reduce(jax.lax.psum(local, axis), nbits)

        fn = jax.jit(
            shard_map(
                encode,
                mesh=self.mesh,
                in_specs=(P(self.axis), P(self.axis), P(self.axis)),
                out_specs=P(),
                check_vma=False,
            )
        )
        self._enc_cache[key] = fn
        return fn

    def _pay_scan_fn(self, kct: int, cmb: int, plen: int, chunk: int):
        key = ("pay", kct, cmb, plen, chunk)
        fn = self._enc_cache.get(key)
        if fn is not None:
            return fn
        from tfhe_omr.core.detector import payload_plain_device

        det = self.detector
        f2 = det.ctx.f2
        ntt2 = det.ctx.ntt2
        idx_p = det.ctx.params.output_plain_modulus
        q2 = f2.q
        axis = self.axis
        nbits = f2.bits + self.n_dev.bit_length() + 1

        def encode(pert, payloads, weights):
            t_loc = pert.shape[0]
            n2v = pert.shape[2]
            cl = min(chunk, t_loc)
            pad = (-t_loc) % cl
            if pad:
                pert = jnp.concatenate(
                    [pert, jnp.zeros((pad,) + pert.shape[1:], pert.dtype)]
                )
                payloads = jnp.concatenate(
                    [payloads,
                     jnp.zeros((pad, payloads.shape[1]), payloads.dtype)]
                )
                weights = jnp.concatenate(
                    [weights,
                     jnp.zeros(weights.shape[:2] + (pad,), weights.dtype)],
                    axis=2,
                )
            nc = pert.shape[0] // cl
            pr = pert.reshape((nc, cl) + pert.shape[1:])
            pl = payloads.astype(jnp.int64).reshape(nc, cl, -1)
            wt = weights.reshape(kct, cmb, nc, cl).transpose(2, 0, 1, 3)

            def body(accs, xs):
                p, pay, w = xs
                pert_t = p.transpose(1, 2, 0)
                out = []
                for k in range(kct):
                    plain = payload_plain_device(
                        pay, w[k], plen, n2v, idx_p, q2
                    )
                    pn = ntt2.fwd(plain.T)
                    prod = f2.mul(pert_t, pn[None])
                    out.append(f2.add(accs[k], f2.mod_sum(prod, axis=2)))
                return jnp.stack(out), None

            acc0 = jnp.zeros((kct, 2, n2v), dtype=jnp.int64)
            local, _ = jax.lax.scan(body, acc0, (pr, pl, wt))
            return f2.reduce(jax.lax.psum(local, axis), nbits)

        fn = jax.jit(
            shard_map(
                encode,
                mesh=self.mesh,
                in_specs=(
                    P(self.axis),
                    P(self.axis),
                    P(None, None, self.axis),
                ),
                out_specs=P(),
                check_vma=False,
            )
        )
        self._enc_cache[key] = fn
        return fn

    def encode_pertinent_indices(self, retrieval_params, pertinency, rng,
                                 chunk: int = 2048):
        """Sharded twin of ``Detector.encode_pertinent_indices`` — same rng
        stream (all bucket draws up front), one shard_map(scan) dispatch,
        psum digest reduce (reference ``detector.rs:223-339``). The
        pertinency stack length must be shard-aligned (detect output is)."""
        rp = retrieval_params
        total = pertinency.shape[0]
        assert total % self.n_dev == 0, (total, self.n_dev)
        buckets = rng.integers(
            0, rp.bucket_count_per_segment,
            size=(total, rp.segment_per_cipher), dtype=np.int64,
        )
        base_addr = (
            np.arange(rp.segment_per_cipher, dtype=np.int64)[None, :]
            * rp.slots_per_segment
            + buckets * rp.slots_per_bucket
        )
        idx = np.arange(total, dtype=np.int64)
        fn = self._idx_scan_fn(
            rp.index_slots_per_bucket, rp.segment_per_cipher,
            min(chunk, total),
        )
        return fn(
            self._shard_pert(pertinency), self._shard(base_addr),
            self._shard(idx),
        )

    def encode_pertinent_payloads(self, retrieval_params, pertinency,
                                  payloads, seed, chunk: int = 2048):
        """Sharded twin of ``Detector.encode_pertinent_payloads`` (reference
        ``detector.rs:341-453``); the rayon tree-reduce at ``:445-449``
        becomes one psum of the per-shard partial sums."""
        from tfhe_omr.core.detector import sample_weights

        rp = retrieval_params
        total = pertinency.shape[0]
        assert total % self.n_dev == 0, (total, self.n_dev)
        weights = sample_weights(rp, seed)
        w_all = weights.reshape(
            rp.cmb_cipher_count, rp.cmb_count_per_cipher, -1
        )[:, :, :total].astype(np.int16)  # prefix-slice like the
        # single-device encoder; int16 (< 257) quarters the upload
        # (a board smaller than the layout's D only uses the first
        # `total` columns of the shared weight stream)
        fn = self._pay_scan_fn(
            rp.cmb_cipher_count, rp.cmb_count_per_cipher,
            rp.payload_length, min(chunk, total),
        )
        sh_w = (
            NamedSharding(self.mesh, P(None, None, self.axis))
        )
        if self._multiproc:
            wh = np.asarray(w_all)
            w_dev = jax.make_array_from_callback(
                wh.shape, sh_w, lambda i: wh[i]
            )
        else:
            w_dev = jax.device_put(jnp.asarray(w_all), sh_w)
        return fn(
            self._shard_pert(pertinency),
            self._shard(np.asarray(payloads, dtype=np.int16)),
            w_dev,
        )
