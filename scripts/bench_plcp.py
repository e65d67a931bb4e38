"""lcpbit at reference scale — PLCP of a >=400 Mbp text on one chip.

Pipeline: synth pacterm DNA -> scaled merge-engine BWT (bwtonly) ->
rate-1 LF walk for the full SA/ISA (bwtcomputessa machinery; no doubling
sort, so device memory stays bounded) -> slab-striped batched-Kasai PLCP
(lcp/plcp.py) -> .lcpbit + native Phi/Kasai spot verification.

The reference's lcpbit is external-memory unbounded
(/root/reference/src/lcpbit.cpp:2371-2850); this is the device-shaped
run of the same construction.

Usage: PYTHONPATH=. python scripts/bench_plcp.py \
           [Mbp] [workdir] [bytes]

The optional third argument ``bytes`` switches to a sigma=256 byte
alphabet (uniform random bytes, inputtype=bytestream): byte-window
Kasai, no nibble packing.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    work = sys.argv[2] if len(sys.argv) > 2 else "/root/bigbuild"
    byte_mode = len(sys.argv) > 3 and sys.argv[3] == "bytes"
    os.makedirs(work, exist_ok=True)
    n = mbp * 1000 * 1000

    from bwtb3m.engine import BwtOptions, compute_bwt, compute_ssa
    from bwtb3m.io import formats
    from bwtb3m.io.inputtypes import parse_input_type
    from bwtb3m.lcp.plcp import (compute_plcp_scaled, write_plcp_file,
                                     PLCPBitDecoder)
    from bwtb3m.util.log import VerboseLog

    log = VerboseLog(1)
    tag = "t%dm%s" % (mbp, "b" if byte_mode else "")
    if byte_mode:
        pac = os.path.join(work, tag + ".bin")
        itype = "bytestream"
        if not os.path.exists(pac):
            rng = np.random.default_rng(42)
            rng.integers(0, 256, n, dtype=np.uint8).tofile(pac)
    else:
        pac = os.path.join(work, tag + ".pac")
        itype = "pacterm"
        if not os.path.exists(pac):
            rng = np.random.default_rng(42)
            nb = n - 1
            payload = rng.integers(0, 256, (nb + 3) // 4, dtype=np.uint8)
            with open(pac, "wb") as f:
                f.write(payload.tobytes())
                if nb % 4 == 0:
                    f.write(b"\x00")
                f.write(bytes([nb % 4]))
            del payload

    stats = {"n": n, "sigma_mode": "byte256" if byte_mode else "pacterm"}
    bwt_path = os.path.join(work, tag + ".bwt")
    if not os.path.exists(bwt_path[:-4] + ".meta"):
        t0 = time.time()
        compute_bwt(BwtOptions(
            input_path=pac, input_type=itype, output_filename=bwt_path,
            engine="merge", bwt_only=True,
            max_block_symbols=128 * 1000 * 1000, verbose=1))
        stats["build_s"] = round(time.time() - t0, 1)

    text, sigma = parse_input_type(itype).load(pac)
    from bwtb3m.util.devmem import device_budget
    dev_budget = device_budget("BWTB3M_PLCP_DEV_BYTES")
    per = 18 if sigma <= 16 else 19
    use_dev = n * per <= dev_budget and os.environ.get(
        "BWTB3M_PLCP_SLAB") != "1"
    out = os.path.join(work, tag + ".lcpbit")
    if use_dev:
        # round-4 device-resident pipeline: the rate-1 SA, ISA, Phi and
        # PLCP never leave HBM; only the packed succinct bits download
        import jax.numpy as jnp
        from bwtb3m.engine.ssa import compute_sa_device
        from bwtb3m.lcp.plcp import (compute_plcp_device,
                                         encode_plcp_bits_device,
                                         write_plcp_bytes)
        t0 = time.time()
        sa_dev, _n = compute_sa_device(bwt_path, log=log)
        stats["ssa_rate1_s"] = round(time.time() - t0, 1)
        log.v("rate-1 SA walk (device): %.1fs" % stats["ssa_rate1_s"])
        t0 = time.time()
        plcp_dev = compute_plcp_device(text.astype(np.int32), sigma,
                                       sa_dev)
        float(jnp.sum(plcp_dev, dtype=jnp.uint32) * 0 + 1)  # force
        stats["plcp_s"] = round(time.time() - t0, 1)
        log.v("device PLCP: %.1fs (%.1f Mbp/s)"
              % (stats["plcp_s"], n / 1e6 / stats["plcp_s"]))
        t0 = time.time()
        nbits, by = encode_plcp_bits_device(plcp_dev)
        write_plcp_bytes(out, n, nbits, by)
        stats["write_s"] = round(time.time() - t0, 1)
        rng = np.random.default_rng(1)
        # verify: decode the file and compare a dense sample against the
        # device PLCP, then the independent circular-extension oracle
        idx = np.sort(rng.integers(0, n, 2_000_000))
        plcp_at = lambda ii: np.asarray(  # noqa: E731
            jnp.take(plcp_dev, jnp.asarray(ii))).astype(np.int64)
        dec = PLCPBitDecoder(out, n=n)
        ok = bool(np.array_equal(dec.all()[idx], plcp_at(idx)))
        sa_np = np.asarray(sa_dev).astype(np.int64)
        isa_np = np.zeros(n, np.int64)
        isa_np[sa_np] = np.arange(n, dtype=np.int64)
        sp = rng.integers(1, n, 2000)
        spv = plcp_at(sp)
    else:
        t0 = time.time()
        sa_path, _isa_path = compute_ssa(bwt_path, 1, 1 << 40, log=log)
        stats["ssa_rate1_s"] = round(time.time() - t0, 1)
        log.v("rate-1 SA walk: %.1fs" % stats["ssa_rate1_s"])
        _r, sa_np = formats.read_sampled_array(sa_path)
        isa_np = np.zeros(n, np.int64)
        isa_np[sa_np] = np.arange(n, dtype=np.int64)
        t0 = time.time()
        plcp, _sa = compute_plcp_scaled(
            text.astype(np.int32), sigma, sa_isa=(sa_np, isa_np))
        stats["plcp_s"] = round(time.time() - t0, 1)
        log.v("slab-striped PLCP: %.1fs (%.1f Mbp/s)"
              % (stats["plcp_s"], n / 1e6 / stats["plcp_s"]))
        t0 = time.time()
        write_plcp_file(out, plcp)
        stats["write_s"] = round(time.time() - t0, 1)
        rng = np.random.default_rng(1)
        idx = np.sort(rng.integers(0, n, 2_000_000))
        dec = PLCPBitDecoder(out, n=n)
        ok = bool(np.array_equal(dec.all()[idx], plcp[idx]))
        sp = rng.integers(1, n, 2000)
        spv = plcp[sp]

    # independent spot oracle: direct circular extension at 2k positions
    bad = 0
    for p, got_l in zip(sp, spv):
        r = isa_np[p]
        if r == 0:
            want = 0
        else:
            q = sa_np[r - 1]
            l = 0
            while l < n and text[(p + l) % n] == text[(q + l) % n]:
                l += 1
            want = l
        if got_l != want:
            bad += 1
    stats["verify_ok"] = bool(ok and bad == 0)
    stats["spot_bad"] = bad
    stats["total_mbps"] = round(
        n / 1e6 / (stats["ssa_rate1_s"] + stats["plcp_s"]
                   + stats["write_s"]), 3)
    print(json.dumps(stats))
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "logs")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "plcp_%dm%s.json" % (mbp, "b" if byte_mode else "")), "w") as f:
        json.dump(stats, f, indent=1)
    if not stats["verify_ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
