"""Smoke test of the detector's main path on one NVIDIA GPU (or four).

    python chip_smoke.py          # one card, phases 1-5 below
    python chip_smoke.py --four   # the sharded path over a 1-D mesh of four

Phases, each on a line of its own; any failure exits non-zero:

1. guard: JAX's first device must be a GPU (there is no CPU fallback);
   prints the device, JAX's version, the compile cache and the card's name
   and power limit as nvidia-smi reports them.
2. the golden vectors (tests/golden/golden_vectors.npz) recomputed on the
   card, compared exactly.
3. the omd oracle at the reference parameters (examples/omd.py).
4. detect of a 1024-message batch at the reference parameters, compared
   bit-exactly with the same stage programs run on the CPU backend on the
   same key arrays and the first clues; prints steady-state ms/msg, the
   per-stage split, first-call seconds per stage and peak device memory.
5. the round trip of examples/omr.py at D=4096, k=50: device clues,
   detect, 5 index + 28 payload digest ciphertexts, client decode;
   payloads must decode byte-exactly.

``--four`` runs only the sharded phase: ShardedDetector over four cards
(detect of 4x1024 messages and both digest encoders at D=4096), compared
bit-exactly with the one-card Detector in the same process.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Each check is a function; tests/test_gpu.py runs them as the ``gpu`` tier.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DETECT_BATCH = 1024
CPU_COMPARE = 8  # messages re-detected on the CPU backend
BOARD_D = 4096
BOARD_K = 50


def load_script(relpath: str):
    """Import one of the repo's scripts by its path from the repo root
    (``tests`` and ``examples`` are not packages, and a same-named installed
    package would win). The tests load the examples through it too."""
    import importlib.util

    name = "_smoke_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath)
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def guard():
    """Phase 1: refuse anything but a GPU, then describe the card.
    Returns the card's ``name, power.limit`` line(s)."""
    import jax

    from tfhe_omr.utils.cache import compile_cache_dir
    from tfhe_omr.utils.devices import card_name_and_power_limit, require_gpu

    dev = require_gpu()
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or compile_cache_dir()
    card = card_name_and_power_limit()
    say("guard", f"device_kind={dev.device_kind!r} count={len(jax.devices())}"
                 f" jax={jax.__version__} compile_cache={cache}")
    say("guard", f"card (name, power.limit): {card}")
    return card


def check_golden() -> int:
    """Phase 2: every golden vector recomputed on the default device equals
    the committed one exactly (integer arithmetic throughout). Returns the
    number of arrays compared."""
    import numpy as np

    vectors = load_script("tests/test_golden.py")
    golden = np.load(vectors.GOLDEN_PATH)
    got = vectors.compute_vectors()
    if set(golden.files) != set(got):
        raise AssertionError(f"golden keys differ: {sorted(golden.files)} "
                             f"vs {sorted(got)}")
    bad = {k: int((golden[k] != got[k]).sum())
           for k in golden.files if not np.array_equal(golden[k], got[k])}
    if bad:
        raise AssertionError(f"golden vectors differ (elements): {bad}")
    return len(golden.files)


def check_omd() -> None:
    """Phase 3: the omd oracle at the reference parameters (its two clues
    padded to the phase-4 batch, so both phases share compiled programs)."""
    from tfhe_omr.core.params import OmrParameters

    load_script("examples/omd.py").omd_check(
        OmrParameters.default(), seed=3, batch=DETECT_BATCH
    )


def _default_detector(seed: int, params=None):
    from tfhe_omr.core.keygen import SecretKeyPack
    from tfhe_omr.core.params import OmrParameters

    skp = SecretKeyPack(params or OmrParameters.default(), rng=seed)
    return skp, skp.generate_detector(), skp.generate_sender()


def check_detect_vs_cpu(batch: int = DETECT_BATCH,
                        compare: int = CPU_COMPARE, reps: int = 3) -> dict:
    """Phase 4: detect ``batch`` messages on the default device, time it,
    and re-run the first ``compare`` messages' stage programs on the CPU
    backend with copies of the same key arrays; all stage outputs must be
    bit-identical. Returns the timings (seconds, bytes)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tfhe_omr.core.sender import ClueBatch

    _, det, sender = _default_detector(seed=0)
    clues = sender.gen_clues(batch, np.random.default_rng(1))
    key, tbl = det.key, det.tables

    def stages(a, b7, key, tbl):
        ms_a, ms_b = det._stage1_jit(a, b7, key.bsk1, key.bsk1_sh,
                                     key.ksk_limbs, tbl)
        acc2 = det._stage2_jit(ms_a, ms_b, key.bsk2, key.bsk2_sh, tbl)
        out = det._stage3_jit(acc2, key.trace_k, key.trace_k_sh)
        return ms_a, ms_b, acc2, out

    # first call per stage: trace + compile + one run
    _, first = det.detect_with_time_info(clues)
    _, split = det.detect_with_time_info(clues)
    t0 = time.perf_counter()
    jax.block_until_ready([det.detect(clues) for _ in range(reps)])
    steady = (time.perf_counter() - t0) / reps
    dev = jax.devices()[0]
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")

    got = stages(jnp.asarray(clues.a), jnp.asarray(clues.b7), key, tbl)
    cpu = jax.devices("cpu")[0]  # raises when JAX has no CPU backend
    small = ClueBatch(clues.a[:compare], clues.b7[:compare])
    ref = stages(
        jax.device_put(small.a, cpu), jax.device_put(small.b7, cpu),
        jax.device_put(key, cpu), jax.device_put(tbl, cpu),
    )
    names = ("stage1 a", "stage1 b", "stage2 acc", "detect out")
    for name, g, r in zip(names, got, ref):
        r = np.asarray(r)
        g = np.asarray(g)
        # stage2's accumulator is (N2, 2, B); every other output leads with B
        g = g[..., :compare] if name == "stage2 acc" else g[:compare]
        if not np.array_equal(g, r):
            raise AssertionError(
                f"{name}: {int((g != r).sum())} of {r.size} elements differ "
                "between the GPU and the CPU backend"
            )
    return {
        "batch": batch,
        "compared_messages": compare,
        "steady_ms_per_msg": 1e3 * steady / batch,
        "stage_ms_per_msg": {
            "stage1": 1e3 * split.first_level_bootstrapping_time / batch,
            "stage2": 1e3 * split.second_level_bootstrapping_time / batch,
            "stage3": 1e3 * split.trace_time / batch,
        },
        "first_call_s": {
            "stage1": first.first_level_bootstrapping_time,
            "stage2": first.second_level_bootstrapping_time,
            "stage3": first.trace_time,
        },
        "peak_bytes_in_use": peak,
    }


def check_roundtrip(d: int = BOARD_D, seed: int = 11) -> dict:
    """Phase 5: examples/omr.py's pipeline at the reference parameters on a
    ``d``-message board with k=50 pertinent; raises unless every true index
    decodes and every decoded payload is byte-exact (a confirmed protocol
    false positive is a success, as in examples/omr.py). Returns its
    result record."""
    omr = load_script("examples/omr.py")
    args = omr.build_parser().parse_args(
        ["-p", str(d), "--batch", str(DETECT_BATCH), "--seed", str(seed)]
    )
    result = omr.run(args)
    if result["pertinent_count"] != BOARD_K:
        raise AssertionError(f"k={result['pertinent_count']}, not {BOARD_K}")
    if not result["ok"]:
        raise AssertionError(f"round trip failed: {result}")
    return result


def check_sharded(n_dev: int = 4, per_card: int = DETECT_BATCH,
                  d: int = BOARD_D, k: int = BOARD_K, params=None) -> dict:
    """Sharded detect of ``n_dev * per_card`` messages over a 1-D mesh of
    ``n_dev`` devices plus both digest encoders at ``d`` messages with ``k``
    pertinent, each bit-identical to the one-device Detector on the same
    inputs (reference parameters unless ``params`` is given). The sharded
    output must live on all ``n_dev`` devices. Logs each step with its
    seconds; returns the timings."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tfhe_omr.core.payload import random_payloads
    from tfhe_omr.core.sender import ClueBatch
    from tfhe_omr.parallel import ShardedDetector, make_data_mesh

    devices = jax.devices()
    if len(devices) < n_dev:
        raise AssertionError(f"need {n_dev} devices, JAX has {len(devices)}")
    log = logging.getLogger("chip_smoke")
    t = [time.perf_counter()]

    def step(msg, *a):
        """Log the seconds since the last step; return them."""
        now = time.perf_counter()
        secs, t[0] = now - t[0], now
        log.info("[%.1f s] " + msg, secs, *a)
        return secs

    skp, det, sender = _default_detector(seed=0, params=params)
    total = n_dev * per_card
    clues = sender.gen_clues(total, np.random.default_rng(1))
    sharded = ShardedDetector(det, make_data_mesh(devices[:n_dev]))
    step("keys, %d clues and the replicated key ready", total)

    pv_s = jax.block_until_ready(sharded.detect(clues))
    first_s = step("sharded detect first call (trace + compile + run)")
    pv_s = jax.block_until_ready(sharded.detect(clues))
    sharded_s = step("sharded detect")
    spread = pv_s.sharding.device_set
    if spread != set(devices[:n_dev]):
        raise AssertionError(f"sharded output on {sorted(d.id for d in spread)}"
                             f", not on all {n_dev} devices")
    in_use = [(dv.memory_stats() or {}).get("bytes_in_use") for dv in
              devices[:n_dev]]
    log.info("bytes in use per device: %s", in_use)
    single = [
        det.detect(ClueBatch(clues.a[s:s + per_card],
                             clues.b7[s:s + per_card]))
        for s in range(0, total, per_card)
    ]
    pv_1 = jnp.concatenate(single)
    if not np.array_equal(np.asarray(pv_s), np.asarray(pv_1)):
        raise AssertionError("sharded detect differs from the one-card detect")
    step("one-device detect of %d batches; sharded == one device", n_dev)

    rp = skp.generate_retriever(d, k).params
    pert_s, pert_1 = pv_s[:d], pv_1[:d]
    idx_s = jax.block_until_ready(sharded.encode_pertinent_indices(
        rp, pert_s, np.random.default_rng(3)))
    idx_1 = det.encode_pertinent_indices(rp, pert_1, np.random.default_rng(3))
    step("index digest, sharded and one device")
    payloads = random_payloads(np.random.default_rng(4), d, rp.payload_length)
    pay_s = jax.block_until_ready(
        sharded.encode_pertinent_payloads(rp, pert_s, payloads, 5))
    pay_1 = det.encode_pertinent_payloads(rp, pert_1, payloads, 5)
    step("payload digests, sharded and one device")
    for name, a, b in (("index digest", idx_s, idx_1),
                       ("payload digests", pay_s, pay_1)):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"sharded {name} differs from one card")
    return {"messages": total, "cards": n_dev,
            "sharded_first_call_s": first_s,
            "sharded_detect_s": sharded_s,
            "sharded_ms_per_msg": 1e3 * sharded_s / total,
            "bytes_in_use_per_card": in_use}


def last_line(devices, ok: bool = True) -> str:
    """The contract's last line: the verdict and the device as JAX reports
    it."""
    return json.dumps({"ok": ok, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path over four cards")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    import jax

    card = guard()
    tag = card.replace("\n", "; ")  # one nvidia-smi line per card

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        say(phase, f"passed in {time.perf_counter() - t0:.3f} s  [{tag}]")
        return out

    if args.four:
        rec = timed("four", check_sharded, 4)
        say("four", f"sharded == one card, bit-exact: {json.dumps(rec)}"
                    f"  [{tag}]")
    else:
        n = timed("golden", check_golden)
        say("golden", f"{n} arrays equal exactly")
        timed("omd", check_omd)
        say("omd", "[1,0,...,0] for the pertinent clue, zeros otherwise")
        rec = timed("detect", check_detect_vs_cpu)
        say("detect", f"GPU == CPU bit-exact on {rec['compared_messages']} "
                      f"of {rec['batch']} messages: {json.dumps(rec)}"
                      f"  [{tag}]")
        res = timed("roundtrip", check_roundtrip)
        say("roundtrip", f"D={res['payload_count']} "
                         f"k={res['pertinent_count']} byte_exact="
                         f"{res['byte_exact']} fp_count={res['fp_count']} "
                         f"stages_s={json.dumps(res['stages_s'])} "
                         f"setup_s={json.dumps(res['setup_s'])}  [{tag}]")
    print(f"card (name, power.limit): {card}", flush=True)
    print(last_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
