import os
import time

import numpy as np
import pytest

from bwtb3m.util.args import ArgInfo, ArgParser, parse_size
from bwtb3m.util.log import RealTimeClock, SizeMonitor, VerboseLog
from bwtb3m.util.serial import (read_number_map, write_number_map)
from bwtb3m.util.tmpfiles import (TempFileNameGenerator,
                                      TempFileRemovalContainer)


def test_parse_size_suffixes():
    assert parse_size("1024") == 1024
    assert parse_size("2k") == 2048
    assert parse_size("3m") == 3 * 1024 ** 2
    assert parse_size("2G") == 2 * 1024 ** 3
    assert parse_size("1.5g") == int(1.5 * 1024 ** 3)


def test_arginfo_parsing(tmp_path):
    f = tmp_path / "in.bin"
    f.write_bytes(b"x")
    ai = ArgInfo(["mem=2g", "bwtonly=1", str(f), "verbose=2"], "prog")
    assert ai.get_int("mem", 0) == 2 * 1024 ** 3
    assert ai.get_bool("bwtonly", False) is True
    assert ai.get_int("verbose", 0) == 2
    assert ai.restargs == [str(f)]
    name = ai.default_tmp_name()
    assert "prog" in name and str(os.getpid()) in name


def test_argparser_flags():
    ap = ArgParser(["-t4", "-T/tmp/prefix", "-test", "file.bwt", "-s8"])
    assert ap.get_int("t", 0) == 4
    assert ap.has("test")
    assert ap.get_int("s", 0) == 8
    assert ap.restargs == ["file.bwt"]


def test_tmpfile_generator(tmp_path):
    gen = TempFileNameGenerator(str(tmp_path / "sub" / "pfx"))
    a = gen.get("sort")
    b = gen.get()
    assert a != b and a.startswith(str(tmp_path / "sub" / "pfx"))
    open(a, "w").write("x")
    gen.cleanup()
    assert not os.path.exists(a)


def test_size_monitor(tmp_path):
    (tmp_path / "f1").write_bytes(b"x" * 1000)
    with SizeMonitor(str(tmp_path), interval=0.05) as mon:
        (tmp_path / "f2").write_bytes(b"y" * 5000)
        time.sleep(0.2)
    assert mon.peak >= 6000


def test_rtc_and_log(capsys):
    rtc = RealTimeClock()
    time.sleep(0.01)
    assert rtc.elapsed() > 0
    log = VerboseLog(2)
    with log.span("phase"):
        pass
    log.w("warn")
    err = capsys.readouterr().err
    assert "[V] phase" in err and "[W] warn" in err


def test_number_map_roundtrip(tmp_path):
    import io as _io
    buf = _io.BytesIO()
    m = {3: 10, 1: 5, 100: 1}
    write_number_map(buf, m)
    buf.seek(0)
    assert read_number_map(buf) == m


# ---------------------------------------------------------------- device memory budgets

class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_budget_cpu_uses_host_memory(monkeypatch):
    import jax

    from bwtb3m.util import devmem

    monkeypatch.delenv("BWTB3M_DEV_HBM", raising=False)
    host = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    assert devmem.device_bytes_limit(jax.devices("cpu")[0]) == host
    assert devmem.device_budget("BWTB3M_DEV_HBM") == int(
        host * devmem.BUDGET_FRACTION)


def test_device_budget_gpu_from_bytes_limit(monkeypatch):
    from bwtb3m.util import devmem

    monkeypatch.delenv("BWTB3M_BATCH_HBM", raising=False)
    gpu = _FakeDevice("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 1})
    assert devmem.device_budget("BWTB3M_BATCH_HBM", gpu) == int(
        (60 << 30) * devmem.BUDGET_FRACTION)
    # the environment override still wins
    monkeypatch.setenv("BWTB3M_BATCH_HBM", "12345")
    assert devmem.device_budget("BWTB3M_BATCH_HBM", gpu) == 12345


def test_device_budget_gpu_without_stats_raises(monkeypatch):
    from bwtb3m.util import devmem

    monkeypatch.delenv("BWTB3M_PLCP_DEV_BYTES", raising=False)
    for stats in (None, {"bytes_in_use": 1}):
        with pytest.raises(RuntimeError, match="no memory limit"):
            devmem.device_budget("BWTB3M_PLCP_DEV_BYTES",
                                 _FakeDevice("gpu", stats))


# ---------------------------------------------------------------- compile cache


@pytest.mark.parametrize("env_dir", [None, "/some/where/cache"])
def test_compile_cache_dir(monkeypatch, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the package leaves the cache dir
    to JAX; without it the cache sits at one fixed path in the checkout."""
    import jax

    import bwtb3m

    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        jax.config.update("jax_compilation_cache_dir", env_dir)
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        bwtb3m._enable_jax_cache()
        want = env_dir or os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(
                bwtb3m.__file__))), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == want
        assert bwtb3m.CACHE_DIR.endswith(os.sep + ".jax_cache")
        assert (jax.config.jax_persistent_cache_min_compile_time_secs
                == bwtb3m.CACHE_MIN_COMPILE_SECS)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])
