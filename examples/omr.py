"""End-to-end OMR run: keygen -> clues -> detect -> digest -> decode -> verify.

Counterpart of reference ``omr_core/examples/omr.rs`` (CLI with
``--payload-count``; the reference's ``--thread-count`` becomes the number of
JAX devices, which is discovered rather than configured). Verifies every
decoded payload byte-wise (``omr.rs:222-232``).

Usage:
    python examples/omr.py [-p PAYLOAD_COUNT] [--tiny] [--batch B] [--cpu]

``run(build_parser().parse_args([...]))`` drives the same pipeline from
another program in the same process and returns the result record.
"""

import argparse
import logging
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

log = logging.getLogger("omr")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("-p", "--payload-count", type=int, default=None)
    ap.add_argument("--batch", type=int, default=128,
                    help="device batch size for detection")
    ap.add_argument("--tiny", action="store_true", help="tiny parameter set")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--sharded", action="store_true",
                    help="shard over all available devices")
    ap.add_argument("--csv", type=str, default=None,
                    help="write a timing record CSV")
    ap.add_argument("--json", type=str, default=None,
                    help="write a JSON artifact (stage walls + verification)")
    ap.add_argument("--host-clues", action="store_true",
                    help="generate clues with host numpy (client mode) "
                         "instead of the on-device batch program")
    ap.add_argument("--profile", type=str, default=None,
                    help="write a jax.profiler trace to this directory")
    ap.add_argument("--seed", type=int, default=None,
                    help="deterministic run seed (required multi-process: "
                         "every process must derive identical keys/clues)")
    # multi-process launch (jax multi-controller runtime): run the SAME
    # command in every process, adding --coordinator host0:port
    # --num-processes N --process-id i. Implies --sharded over the global
    # mesh; the digest psum is the only collective (SURVEY.md §2.4).
    ap.add_argument("--coordinator", type=str, default=None,
                    help="coordinator address host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap


def main():
    args = build_parser().parse_args()
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    sys.exit(0 if run(args)["ok"] else 1)


def run(args) -> dict:
    """The whole pipeline; returns the result record (``ok`` is the
    verification verdict) and writes the CSV / JSON artifacts asked for."""
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    multiproc = False
    if args.coordinator:
        from tfhe_omr.parallel import distributed

        distributed.init(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
        multiproc = distributed.is_multihost()
        if multiproc:
            assert args.seed is not None, (
                "--seed is required multi-process: every process must "
                "derive identical keys and clue streams"
            )
            args.sharded = True
            # global arrays are assembled from identical host copies in
            # multi-controller runs (parallel/mesh.py), so clues come from
            # the host path
            args.host_clues = True

    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters
    from tfhe_omr.core.payload import random_payloads
    from tfhe_omr.core.sender import ClueBatch
    from tfhe_omr.utils.timing import TimingRecord, write_csv

    params = OmrParameters.tiny() if args.tiny else OmrParameters.default()
    n_dev = len(jax.devices())
    all_count = args.payload_count or n_dev * 8
    pertinent_count = min(all_count, 50 if not args.tiny else 8)
    log.info("devices: %d, payloads: %d, pertinent: %d",
             n_dev, all_count, pertinent_count)

    rec = TimingRecord(device_count=n_dev, payload_count=all_count)
    setup_s = {}  # set-up phases outside the timed pipeline stages
    total0 = time.perf_counter()

    log.info("generating secret key packs...")
    if args.seed is not None:
        skp = SecretKeyPack(params, rng=args.seed)
        skp2 = SecretKeyPack(params, rng=args.seed + 1)
    else:
        skp = SecretKeyPack(params, rng=np.random.default_rng())
        skp2 = SecretKeyPack(params, rng=np.random.default_rng())
    sender = skp.generate_sender()
    sender2 = skp2.generate_sender()
    detector = skp.generate_detector()
    jax.block_until_ready(detector.key)
    setup_s["keygen"] = time.perf_counter() - total0
    log.info("detection key size: %.1f MB", detector.detect_key_size() / 1e6)
    if not multiproc:
        # execute one dummy batch so the stage executables compile and load
        # outside the timed region
        t0 = time.perf_counter()
        jax.block_until_ready(detector.detect(ClueBatch(
            np.zeros((args.batch, params.clue_params.dimension), np.int64),
            np.zeros((args.batch, params.clue_count), np.int64),
        )))
        setup_s["detect_first_batch"] = time.perf_counter() - t0
        log.info("executable load + first batch: %.1fs",
                 setup_s["detect_first_batch"])

    rng = np.random.default_rng(
        args.seed + 2 if args.seed is not None else None
    )
    pertinent = np.zeros(all_count, dtype=bool)
    pertinent[:pertinent_count] = True
    rng.shuffle(pertinent)
    true_indices = sorted(np.nonzero(pertinent)[0].tolist())

    import jax.numpy as jnp

    log.info("generating clues...")
    n_dim = params.clue_params.dimension
    n_pert = int(pertinent.sum())
    if not args.host_clues:
        # load the clue-chunk executables outside the timed region, like
        # the detect stages above
        jax.block_until_ready(sender.gen_clues_device_resident(8, 0))
        jax.block_until_ready(sender2.gen_clues_device_resident(8, 0))
    t0 = time.perf_counter()
    if args.host_clues:
        own = sender.gen_clues(n_pert, rng)
        other = sender2.gen_clues(all_count - n_pert, rng)
        a = np.zeros((all_count, own.a.shape[1]), dtype=np.int64)
        b7 = np.zeros((all_count, own.b7.shape[1]), dtype=np.int64)
        a[pertinent], b7[pertinent] = own.a, own.b7
        a[~pertinent], b7[~pertinent] = other.a, other.b7
        clue_buf = None
    else:
        # device path (default): whole-batch int8 dots, clues stay
        # DEVICE-RESIDENT — detect consumes them in place, so the only
        # host<->device clue traffic is a (D,) int32 permutation upload
        own_d = sender.gen_clues_device_resident(
            n_pert, int(rng.integers(1 << 62))
        )
        other_d = sender2.gen_clues_device_resident(
            all_count - n_pert, int(rng.integers(1 << 62))
        )
        perm = np.zeros(all_count, dtype=np.int32)
        perm[pertinent] = np.arange(n_pert, dtype=np.int32)
        perm[~pertinent] = n_pert + np.arange(
            all_count - n_pert, dtype=np.int32
        )
        clue_buf = jnp.take(
            jnp.concatenate([own_d, other_d]).astype(jnp.int64),
            jnp.asarray(perm), axis=0,
        )
        jax.block_until_ready(clue_buf)
        a = b7 = None
    rec.gen_clues_time = time.perf_counter() - t0
    log.info("gen clues time: %.3fs", rec.gen_clues_time)

    t0 = time.perf_counter()
    payloads = random_payloads(rng, all_count, params.payload_length)
    rec.gen_payloads_time = time.perf_counter() - t0

    runner = detector
    if args.sharded and n_dev > 1:
        from tfhe_omr.parallel import ShardedDetector, make_data_mesh

        runner = ShardedDetector(detector, make_data_mesh())
    if multiproc:
        # multi-controller: one global dispatch per stage (batching a
        # global sharded array would slice across processes); the board
        # must tile the global mesh exactly — zero-clue padding rows are
        # PERTINENT (phase 0) and would pollute the digest
        assert all_count % n_dev == 0, (all_count, n_dev)
        assert args.batch >= all_count, (
            "multi-process runs dispatch the whole board at once: "
            "--batch >= payload count"
        )
        args.batch = all_count

    log.info("detecting...")
    if args.profile:
        jax.profiler.start_trace(args.profile)
    t0 = time.perf_counter()
    bsz = args.batch
    if args.sharded and n_dev > 1:
        bsz = -(-bsz // n_dev) * n_dev
    done = 0
    # keep the pertinency ciphertexts ON DEVICE: pulling them to host and
    # re-uploading would move 2x ~2.1 GB at D=65536 — the digest encoders
    # consume them in place. Batches land in a
    # preallocated buffer via a DONATED dynamic-update-slice (a 128-ary
    # device concatenate takes minutes to compile).
    pv = None
    upd = jax.jit(
        lambda buf, val, s: jax.lax.dynamic_update_slice(
            buf, val, (s, 0, 0)
        ),
        donate_argnums=0,
    )
    if clue_buf is not None and all_count % bsz:
        # pad the device buffer once so every batch slice is full-size
        clue_buf = jnp.concatenate([
            clue_buf,
            jnp.zeros((bsz - all_count % bsz, clue_buf.shape[1]),
                      dtype=clue_buf.dtype),
        ])
    for s in range(0, all_count, bsz):
        c = min(bsz, all_count - s)
        pad = bsz - c
        if clue_buf is not None:  # device-resident slices, zero uploads
            cab = jax.lax.dynamic_slice_in_dim(clue_buf, s, bsz)
            ca, cb = cab[:, :n_dim], cab[:, n_dim:]
        else:
            ca = np.concatenate(
                [a[s : s + c], np.zeros((pad, a.shape[1]), np.int64)]
            )
            cb = np.concatenate(
                [b7[s : s + c], np.zeros((pad, b7.shape[1]), np.int64)]
            )
        out = runner.detect(ClueBatch(ca, cb))
        if multiproc:
            # single global dispatch: the sharded result IS the stack
            pv = out
            done += c
            log.info("  detected %d/%d", done, all_count)
            continue
        if pv is None:
            pv = jnp.zeros(
                (all_count,) + out.shape[1:], dtype=out.dtype
            )
        if c == bsz:
            pv = upd(pv, out, s)
        else:  # final partial batch: one eager (unfused) update
            pv = jax.lax.dynamic_update_slice(pv, out[:c], (s, 0, 0))
        done += c
        log.info("  detected %d/%d", done, all_count)
    jax.block_until_ready(pv)
    if args.profile:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", args.profile)
    rec.detect_time = time.perf_counter() - t0
    rec.detect_time_per_message = rec.detect_time / all_count
    log.info("detect time: %.3fs (%.2f ms/msg, %.1f msg/s)",
             rec.detect_time, 1e3 * rec.detect_time_per_message,
             all_count / rec.detect_time)

    retriever = skp.generate_retriever(all_count, pertinent_count)
    rp = retriever.params

    if not (args.sharded and n_dev > 1):
        # load + run the encoder executables once on a zero stack so the
        # timed encodes below are steady-state
        t0 = time.perf_counter()
        _zero_pert = jnp.zeros_like(pv)
        _ct = detector.encode_pertinent_indices(
            rp, _zero_pert, np.random.default_rng(0)
        )
        _pc = detector.encode_pertinent_payloads(
            rp, _zero_pert, np.zeros_like(payloads), 0
        )
        jax.block_until_ready((_ct, _pc))
        del _zero_pert
        setup_s["encoder_first_run"] = time.perf_counter() - t0
        log.info("encoder executable load + warm run: %.1fs",
                 setup_s["encoder_first_run"])

    log.info("encoding index digests...")
    t0 = time.perf_counter()
    # the runner (sharded or single-device) drives the digest encoders, so
    # --sharded runs the psum reduce end-to-end (reference detector.rs
    # :333-336,445-449's rayon tree-reduce)
    index_cts = [
        runner.encode_pertinent_indices(rp, pv, rng)
        for _ in range(rp.max_encode_indices_cipher_count)
    ]
    jax.block_until_ready(index_cts)
    rec.encode_indices_time = time.perf_counter() - t0
    log.info("encode indices time: %.3fs (%d ciphertexts)",
             rec.encode_indices_time, len(index_cts))

    seed = int(rng.integers(0, 2**63))
    log.info("encoding payload digests...")
    t0 = time.perf_counter()
    payload_cts = runner.encode_pertinent_payloads(rp, pv, payloads, seed)
    jax.block_until_ready(payload_cts)
    rec.encode_payloads_time = time.perf_counter() - t0
    log.info("encode payloads time: %.3fs (%d ciphertexts)",
             rec.encode_payloads_time, payload_cts.shape[0])

    # the retriever is the weak CLIENT: download its digest (the protocol's
    # wire transfer) and precompile its decrypt programs before timing the
    # decode itself, mirroring the reference's AOT-compiled client
    t0 = time.perf_counter()
    retriever.warm()
    index_cts = [np.asarray(ct) for ct in index_cts]
    payload_cts = np.asarray(payload_cts)
    setup_s["digest_download_client_warm"] = time.perf_counter() - t0
    log.info("digest download + client warm: %.3fs",
             setup_s["digest_download_client_warm"])

    log.info("decoding digest...")
    t0 = time.perf_counter()
    indices, solved = retriever.decode_digest(index_cts, payload_cts, seed)
    rec.decode_time = time.perf_counter() - t0
    log.info("decode time: %.3fs", rec.decode_time)

    # digest-noise telemetry (NoiseSigmaInfo counterpart): observed sigma
    # of the payload digest vs the digit-decode margin delta/2 — quantifies
    # how far each run sits from a digit/flag flip (a ~4-sigma margin means
    # rare tail flips at D-scale are EXPECTED, matching the reference's
    # failure model, retriever.rs:390-560)
    nsi = retriever.noise_sigma_info(payload_cts, 1.0)
    q2_, p_ = params.q2, retriever.params.index_modulus
    margin = (2 * q2_ + p_) // (2 * p_) / 2
    log.info(
        "digest noise: observed sigma %.3e, decode margin %.3e (%.2f sigma)",
        nsi["observed_sigma"], margin,
        margin / max(nsi["observed_sigma"], 1e-300),
    )

    rec.total_time = time.perf_counter() - total0

    # Verification semantics (counterpart of the reference's own subset
    # assertion, ``examples/omr_time_analyze.rs:215-235``): the protocol has
    # a DESIGNED false-positive rate of t^-clue_count = 8^-7 per message
    # (``detector.rs:479-503``), so a decoded extra index is not a framework
    # failure — it is a real board message the detector flagged, and its
    # payload must still decode byte-exactly. The oracle is therefore:
    #   true_indices  SUBSET OF  decoded, AND
    #   every decoded index's payload == its board payload (byte-exact).
    # Each extra index is then confirmed deterministically by decrypting its
    # clue_count clues under the recipient key: a protocol FP has ALL of
    # them decrypt to 0 (LUT1's accept value, ``detector.rs:457-476``).
    true_set = set(true_indices)
    decoded_set = set(indices)
    missing = [i for i in true_indices if i not in decoded_set]
    extras = [i for i in indices if i not in true_set]
    subset_ok = not missing
    payload_ok = np.array_equal(solved, payloads[indices])
    fp_events = []
    for i in extras:
        if clue_buf is not None:
            row = np.asarray(clue_buf[i]).astype(np.int64)
            a_i, b_i = row[:n_dim], row[n_dim:]
        else:
            a_i, b_i = a[i], b7[i]
        vals = skp.decrypt_compact_clue(a_i, b_i)
        confirmed = bool((vals == 0).all())
        fp_events.append({
            "index": int(i),
            "clue_values_mod_t": [int(v) for v in vals],
            "protocol_fp_confirmed": confirmed,
        })
        (log.info if confirmed else log.error)(
            "extra index %d: clue decryptions %s -> %s", i, list(vals),
            "protocol false positive (all clues decrypt to 0)" if confirmed
            else "NOT a clue collision - framework bug",
        )
    # an extra index is only acceptable if the per-event oracle CONFIRMS
    # it as a clue collision — an unconfirmed extra is a framework bug
    # even when its payload happens to decode byte-exactly
    fp_all_confirmed = all(e["protocol_fp_confirmed"] for e in fp_events)
    ok = subset_ok and payload_ok and fp_all_confirmed
    if missing:
        log.error("missing true indices: %s (decoded %d, true %d)",
                  missing[:10], len(indices), len(true_indices))
    if not payload_ok:
        diff = int((solved != payloads[indices]).sum())
        log.error("payload mismatch: %d differing bytes", diff)
    if ok:
        log.info(
            "all %d decoded payloads verified byte-wise (%d protocol FPs). "
            "All done in %.1fs", len(indices), len(extras), rec.total_time,
        )

    dev0 = jax.devices()[0]
    result = {
        "ok": bool(ok),
        "payload_count": all_count,
        "pertinent_count": pertinent_count,
        "byte_exact": bool(payload_ok),
        "true_subset_of_decoded": bool(subset_ok),
        "fp_count": len(extras),
        "fp_events": fp_events,
        "stages_s": {
            "gen_clues": rec.gen_clues_time,
            "detect": rec.detect_time,
            "detect_ms_per_message": 1e3 * rec.detect_time_per_message,
            "encode_indices": rec.encode_indices_time,
            "encode_payloads": rec.encode_payloads_time,
            "decode": rec.decode_time,
            "total": rec.total_time,
        },
        "setup_s": setup_s,
        "device": {
            "platform": dev0.platform,
            "kind": dev0.device_kind,
            "count": n_dev,
        },
    }
    if multiproc and jax.process_index() != 0:
        args.csv = args.json = None  # one artifact writer per run
    if args.csv:
        write_csv(args.csv, [rec])
    if args.json:
        import json as _json

        with open(args.json, "w") as fh:
            _json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main()
