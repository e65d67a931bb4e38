"""Large-text build driver — the reference's raison d'être on a device.

Synthesizes a pacterm-style text (random DNA bases {1..4}, unique
terminator 0), builds the BWT with the scaled blockwise merge engine
(bwtonly), verifies it with the full checkbwt LF walk, and prints a JSON
summary: e.g. a >2^31-symbol build or the 3.2 Gbp flagship,
checkbwt-verified on one device + host RAM.

Usage:
  PYTHONPATH=. python scripts/build_big.py <Mbp> \
      [block_mb] [workdir]
e.g. 400, 2200 (>2^31), 3200 (flagship).

Every run also writes its JSON summary to ``logs/`` in the repo (not
committed); tee stderr into ``logs/build_<mbp>m.log`` for the full
phase trace.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    block_mb = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    work = sys.argv[3] if len(sys.argv) > 3 else "/root/bigbuild"
    os.makedirs(work, exist_ok=True)
    n = mbp * 1000 * 1000

    from bwtb3m.engine import BwtOptions, check_bwt, compute_bwt
    from bwtb3m.util.log import VerboseLog

    log = VerboseLog(1)
    pac = os.path.join(work, "t%dm.pac" % mbp)
    if not os.path.exists(pac):
        t0 = time.time()
        rng = np.random.default_rng(42)
        # random DNA: every packed byte is uniform uint8, so synthesize
        # the .pac payload directly (4x less data + no packing passes;
        # this host moves bytes at ~2 GB/s)
        nb = n - 1            # bases (text = bases + terminator)
        payload = rng.integers(0, 256, (nb + 3) // 4, dtype=np.uint8)
        with open(pac, "wb") as f:
            f.write(payload.tobytes())
            if nb % 4 == 0:
                f.write(b"\x00")
            f.write(bytes([nb % 4]))
        log.v("synth %d Mbp pacterm: %.1fs" % (mbp, time.time() - t0))
        del payload

    hostmem = int(os.environ.get("BWTB3M_HOSTMEM", "0")) or None
    stats = {"n": n, "block_mb": block_mb,
             "blocks": -(-n // (block_mb * 1000 * 1000)),
             "device_tree": os.environ.get("BWTB3M_DEVICE_TREE", "1")
             != "0",
             "hostmem": hostmem,
             "date": time.strftime("%Y-%m-%d %H:%M")}
    t0 = time.time()
    out_bwt = os.path.join(work, "t%dm.bwt" % mbp)
    res = compute_bwt(BwtOptions(
        input_path=pac, input_type="pacterm",
        output_filename=out_bwt,
        engine="merge", bwt_only=True,
        max_block_symbols=block_mb * 1000 * 1000,
        batch_merges=os.environ.get("BWTB3M_BATCHMERGES", "1") != "0",
        host_mem=hostmem,
        verbose=int(os.environ.get("BWTB3M_VERBOSE", "2"))))
    stats["build_s"] = round(time.time() - t0, 1)
    # durable checkpoint evidence (engine/checkpoint.py writes
    # <tmp_prefix>_BWTREG1_reg_* for completed regions >= min_symbols)
    import glob
    stats["checkpoint_files"] = len(
        glob.glob(out_bwt + "_tmp_BWTREG1_reg_*"))
    log.v("build: %.1fs (%.1f Mbp/s end-to-end)"
          % (stats["build_s"], n / 1e6 / stats["build_s"]))

    # full-text verification (checkbwt oracle)
    from bwtb3m.io.inputtypes import parse_input_type
    t0 = time.time()
    text, _sigma = parse_input_type("pacterm").load(pac)
    ok = check_bwt(res, text)
    stats["checkbwt_s"] = round(time.time() - t0, 1)
    stats["checkbwt_ok"] = bool(ok)
    log.v("checkbwt: ok=%s in %.1fs" % (ok, stats["checkbwt_s"]))
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM"):
                    stats["peak_rss_gb"] = round(
                        int(line.split()[1]) / 1024 / 1024, 2)
    except OSError:
        pass
    print(json.dumps(stats))
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "logs")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "build_%dm.json" % mbp), "w") as f:
        json.dump(stats, f, indent=1)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
