#!/usr/bin/env python3
"""Smoke run of the genome index build on one GPU.

Drives the BWA-index deployment end to end in one process, through the
tools a user calls (``bwtb3m.cli.dispatch``), on inputs generated from
``--seed``:

  1. device check: a GPU, its name and power limit;
  2. the native host codecs rebuilt from source;
  3. single-block build (prefix doubling), chr21 length;
  4. merge-engine BWA build (bwtb3m -> checkbwt -> bwtb3mtobwa), chr1
     length, sasamplingrate=32 isasamplingrate=262144;
  5. succinct LCP (lcpbit -> checkLCPBit) on 2^24 symbols.

Every output is compared exactly with an independent oracle: the native
SA-IS suffix array and the native Kasai PLCP.  Any failure raises, so
the script exits non-zero and prints no result line.

``--chips 4`` runs only the paths that exist across devices (the sharded
doubling engine and the mesh-sharded merge chains), each compared bit for
bit with the single-device result.

Usage: python chip_smoke.py [--seed S] [--chips 1|4]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from bwtb3m import native
from bwtb3m.cli import dispatch
from bwtb3m.index.bwa import read_bwa_bwt, read_bwa_sa
from bwtb3m.io import formats
from bwtb3m.io.pac import write_pac
from bwtb3m.io.rl import rl_decode

# deployment lengths: GRCh38 chr21 and chr1
CHR21 = 46_709_983
CHR1 = 248_956_422
LCP_N = 1 << 24
SA_RATE = 32
ISA_RATE = 262_144


# ------------------------------------------------------------- accounting

class Clock:
    """Wall and compile (set-up) seconds of each timed step, read from
    JAX's compile-duration events."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self, label: str):
        import jax

        self.label = label
        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, secs: float, **_kw) -> None:
        if event in self._EVENTS:
            self.compile_s += secs

    def run(self, name: str, fn, **extra):
        """Runs fn(), waits for every live device array, prints one line."""
        import jax

        c0 = self.compile_s
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(jax.live_arrays())
        wall = time.perf_counter() - t0
        setup = self.compile_s - c0
        fields = ["wall_s=%.3f" % wall, "compile_s=%.3f" % setup]
        fields += ["%s=%s" % kv for kv in extra.items()]
        fields.append("peak_device_bytes=%s" % peak_bytes())
        print("[%s] %s: %s" % (self.label, name, " ".join(fields)),
              flush=True)
        return out, wall, setup


def peak_bytes(device=None):
    import jax

    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def gpu_labels() -> list:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()


def device_check(devices, count: int) -> None:
    """Refuses anything but ``count`` GPU devices."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            "chip_smoke: JAX platform is %r, not 'gpu'; this smoke runs "
            "only on the card" % platform)
    if len(devices) < count:
        raise SystemExit("chip_smoke: %d GPU(s) found, %d needed"
                         % (len(devices), count))


def rebuild_native() -> None:
    """Compiles the native codecs from the committed source, dropping any
    library built elsewhere."""
    if os.path.exists(native._SO):
        os.remove(native._SO)
    if native.get_lib() is None:
        raise RuntimeError("native codecs failed to build from %s"
                           % native._SRC)


# ---------------------------------------------------------------- inputs

def write_pacterm(workdir: str, name: str, n_bases: int, seed: int):
    """Writes a .pac of n_bases seeded DNA bases; returns (path, text)
    where text is the pacterm text: bases 1..4, terminator 0 appended."""
    codes = np.random.default_rng(seed).integers(0, 4, n_bases,
                                                 dtype=np.uint8)
    path = os.path.join(workdir, name + ".pac")
    write_pac(path, codes)
    text = np.empty(n_bases + 1, np.uint8)
    text[:-1] = codes + 1
    text[-1] = 0
    return path, text


def oracle_sa(text: np.ndarray) -> np.ndarray:
    sa = native.sais(text)
    if sa is None:
        raise RuntimeError("native SA-IS unavailable")
    return sa


def check_bwt_and_sa(bwt_path: str, text: np.ndarray, sa: np.ndarray,
                     sa_rate: int) -> None:
    """The decoded .bwt equals text[SA - 1] and .sa equals SA[::rate]."""
    expect = text[sa - 1]       # sa - 1 == -1 reads the last symbol
    got = rl_decode(bwt_path)
    if not np.array_equal(got, expect):
        bad = np.flatnonzero(got != expect)
        raise AssertionError("%s differs from SA-IS at %d positions, first %d"
                             % (bwt_path, len(bad), bad[0] if len(bad) else -1))
    rate, vals = formats.read_sampled_array(
        bwt_path[:-4] + ".sa")
    if rate != sa_rate or not np.array_equal(vals, sa[::sa_rate]):
        raise AssertionError("sampled .sa differs from SA-IS[::%d]" % sa_rate)


def check_bwa(out_bwt: str, out_sa: str, text: np.ndarray, sa: np.ndarray,
              sa_rate: int) -> None:
    """BWA .bwt/.sa read back equal the SA-IS derived rows."""
    primary, l2, bases = read_bwa_bwt(out_bwt)
    expect_primary = int(np.flatnonzero(sa == 0)[0])
    expect = np.delete(text[sa - 1], expect_primary).astype(np.int64) - 1
    if primary != expect_primary or not np.array_equal(bases, expect):
        raise AssertionError("BWA .bwt differs from SA-IS")
    if not np.array_equal(l2, np.cumsum(np.bincount(expect, minlength=4))):
        raise AssertionError("BWA .bwt L2 counts differ")
    p2, _l2, intv, seq_len, vals = read_bwa_sa(out_sa)
    if (p2 != expect_primary or intv != sa_rate
            or seq_len != len(text) - 1
            or not np.array_equal(vals, sa[::sa_rate][1:])):
        raise AssertionError("BWA .sa differs from SA-IS")


def cli(*argv: str) -> None:
    rc = dispatch(list(argv))
    if rc != 0:
        raise RuntimeError("%s exited %d" % (argv[0], rc))


# ---------------------------------------------------------------- phases

def phase_single_block(clock: Clock, workdir: str, n_bases: int,
                       seed: int) -> None:
    """Single-block prefix-doubling build: engine=auto under mem=2G."""
    pac, text = write_pacterm(workdir, "single", n_bases, seed)
    clock.run("single-block bwtb3m", lambda: cli(
        "bwtb3m", "inputtype=pacterm", "engine=auto", "bwtonly=0",
        "sasamplingrate=%d" % SA_RATE, "isasamplingrate=%d" % ISA_RATE,
        "verbose=0", pac), n=len(text))
    sa, _w, _s = clock.run("single-block SA-IS oracle",
                           lambda: oracle_sa(text))
    check_bwt_and_sa(pac + ".bwt", text, sa, SA_RATE)
    print("[%s] single-block: .bwt and .sa equal SA-IS" % clock.label)


def phase_merge_bwa(clock: Clock, workdir: str, n_bases: int, seed: int,
                    mem: str = "2G") -> None:
    """Merge-engine build with the sampled SA, then checkbwt and the BWA
    export, against SA-IS."""
    pac, text = write_pacterm(workdir, "merge", n_bases, seed)
    n = len(text)
    clock.run("merge bwtb3m", lambda: cli(
        "bwtb3m", "inputtype=pacterm", "mem=%s" % mem, "bwtonly=0",
        "sasamplingrate=%d" % SA_RATE, "isasamplingrate=%d" % ISA_RATE,
        "verbose=1", pac), n=n)
    _o, wall, setup = clock.run("checkbwt", lambda: cli(
        "checkbwt", "inputtype=pacterm", "verbose=1", pac, pac + ".bwt"))
    print("[%s] checkbwt: ok, LF steps/s=%.0f (wall), %.0f (wall - compile)"
          % (clock.label, n / wall, n / max(wall - setup, 1e-9)))
    out_bwt = os.path.join(workdir, "bwa.bwt")
    out_sa = os.path.join(workdir, "bwa.sa")
    clock.run("bwtb3mtobwa", lambda: cli(
        "bwtb3mtobwa", "verbose=0", pac + ".bwt", out_bwt, out_sa))
    sa, _w, _s = clock.run("merge SA-IS oracle", lambda: oracle_sa(text))
    check_bwt_and_sa(pac + ".bwt", text, sa, SA_RATE)
    check_bwa(out_bwt, out_sa, text, sa, SA_RATE)
    print("[%s] merge: .bwt, .sa and BWA .bwt/.sa equal SA-IS"
          % clock.label)


def phase_lcp(clock: Clock, workdir: str, n: int, seed: int) -> None:
    """lcpbit + checkLCPBit; the PLCP equals the native Kasai PLCP."""
    from bwtb3m.lcp.plcp import PLCPBitDecoder

    pac, text = write_pacterm(workdir, "lcp", n - 1, seed)
    clock.run("lcp bwtb3m", lambda: cli(
        "bwtb3m", "inputtype=pacterm", "bwtonly=1", "verbose=0", pac), n=n)
    bwt = pac + ".bwt"
    clock.run("lcpbit", lambda: cli("lcpbit", bwt))
    clock.run("checkLCPBit", lambda: cli("checkLCPBit", pac + ".lcpbit", bwt))
    plcp = native.kasai_plcp(text, oracle_sa(text))
    if plcp is None or not np.array_equal(
            PLCPBitDecoder(pac + ".lcpbit", n=n).all(), plcp):
        raise AssertionError("PLCP differs from the native Kasai PLCP")
    print("[%s] lcp: PLCP equals native Kasai" % clock.label)


def phase_mesh(clock: Clock, workdir: str, n_bases: int, seed: int,
               n_devices: int) -> None:
    """Sharded doubling build and mesh-sharded merge chains (lane- and
    occ-sharded), each bit-identical to the single-device run."""
    import jax

    from bwtb3m.engine.merge_scaled import blockwise_bwt_scaled
    from bwtb3m.engine.options import BwtOptions
    from bwtb3m.parallel import make_mesh

    pac, text = write_pacterm(workdir, "mesh", n_bases, seed)
    n = len(text)
    common = ("inputtype=pacterm", "bwtonly=1", "verbose=0")
    shard_out = os.path.join(workdir, "sharded.bwt")
    clock.run("sharded bwtb3m (%d devices)" % n_devices, lambda: cli(
        "bwtb3m", "engine=sharded", "outputfilename=" + shard_out,
        *common, pac), n=n)
    peaks = [peak_bytes(d) for d in jax.devices()[:n_devices]]
    print("[%s] per-device peak bytes after sharded build: %s"
          % (clock.label, peaks))
    # the CPU backend reports no memory stats; every GPU does
    if any(isinstance(p, int) and p < n // n_devices for p in peaks):
        raise AssertionError("a device held less than its text shard: %s"
                             % peaks)
    single_out = os.path.join(workdir, "single.bwt")
    clock.run("single-device bwtb3m", lambda: cli(
        "bwtb3m", "engine=doubling", "outputfilename=" + single_out,
        *common, pac), n=n)
    sa, _w, _s = clock.run("mesh SA-IS oracle", lambda: oracle_sa(text))
    sharded = rl_decode(shard_out)
    if not (np.array_equal(sharded, rl_decode(single_out))
            and np.array_equal(sharded, text[sa - 1])):
        raise AssertionError("sharded BWT differs from the single device")
    print("[%s] sharded doubling: bit-identical to single device and SA-IS"
          % clock.label)

    opts = BwtOptions(input_path=pac, output_filename=single_out,
                      max_block_symbols=n // 4 + 1, verbose=0)
    mesh = make_mesh(n_devices)
    ref, _w, _s = clock.run("single-device scaled merge", lambda: (
        blockwise_bwt_scaled(text, 5, opts, sample_rate=1024)))
    for mode, occ in (("lane-sharded", "0"), ("occ-sharded", "1")):
        os.environ["BWTB3M_SHARD_OCC"] = occ
        try:
            got, _w, _s = clock.run("%s mesh merge" % mode, lambda: (
                blockwise_bwt_scaled(text, 5, opts, sample_rate=1024,
                                     mesh=mesh)))
        finally:
            del os.environ["BWTB3M_SHARD_OCC"]
        if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError("%s merge differs from single device" % mode)
        print("[%s] %s merge: bit-identical to single device"
              % (clock.label, mode))
    if not np.array_equal(ref[0], text[sa - 1]):
        raise AssertionError("scaled merge BWT differs from SA-IS")


# ----------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    print("jax.devices():", devices, flush=True)
    device_check(devices, args.chips)
    dev = devices[0]
    cards = gpu_labels()
    print("device_kind: %s" % dev.device_kind)
    print("nvidia-smi --query-gpu=name,power.limit:")
    print("\n".join(cards), flush=True)
    label = "%s | %s" % (dev.device_kind, cards[0])
    clock = Clock(label)
    clock.run("native codecs from source", rebuild_native)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.chips == 4:
            phase_mesh(clock, workdir, CHR21, args.seed, 4)
        else:
            phase_single_block(clock, workdir, CHR21, args.seed)
            phase_merge_bwa(clock, workdir, CHR1, args.seed + 1)
            phase_lcp(clock, workdir, LCP_N, args.seed + 2)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
