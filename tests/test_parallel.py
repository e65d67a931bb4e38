"""Sharded path vs single-device path: bit-equality on the virtual CPU mesh.

This is the rebuild's analog of the reference's "fake scale" testing
(SURVEY.md section 4 note): many tiny blocks on a small mesh, asserted
bit-identical to the single-block path.
"""

import jax
import numpy as np
import pytest

from bwtb3m.ops.doubling import suffix_array
from bwtb3m.parallel import make_mesh, sharded_bwt
from oracle import naive_bwt, naive_circular_sa, random_string


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


@pytest.mark.parametrize("n,sigma", [(64, 2), (256, 4), (1024, 4), (2048, 16),
                                     (4096, 256)])
def test_sharded_matches_single(mesh8, n, sigma):
    text = random_string(n, sigma, seed=n + sigma)
    sa1, _isa, bwt1 = suffix_array(text, sigma)
    sa8, rank8, bwt8 = sharded_bwt(text, sigma, mesh8)
    np.testing.assert_array_equal(sa8, sa1)
    np.testing.assert_array_equal(bwt8, bwt1)
    np.testing.assert_array_equal(rank8[sa8], np.arange(n))


def test_sharded_tiny_oracle(mesh8):
    text = np.array([ord(c) for c in "abracadabra_abracadabra_abracadr"],
                    dtype=np.int32)
    assert len(text) == 32
    sa8, _r, bwt8 = sharded_bwt(text, 256, mesh8)
    np.testing.assert_array_equal(sa8, naive_circular_sa(text))
    np.testing.assert_array_equal(bwt8, naive_bwt(text))


def test_sharded_periodic(mesh8):
    text = np.tile(np.array([0, 1], np.int32), 16)  # "ababab..." ties
    sa8, _r, bwt8 = sharded_bwt(text, 2, mesh8)
    np.testing.assert_array_equal(bwt8, naive_bwt(text))
    np.testing.assert_array_equal(sa8, naive_circular_sa(text))


def test_indivisible_length_works(mesh8):
    # n % D != 0 handled by pad slots since round 2 (used to raise)
    text = random_string(100, 4, 0)
    sa, _r, bwt = sharded_bwt(text, 4, mesh8)
    sa1, _isa, bwt1 = suffix_array(text, 4)
    import numpy as np
    assert np.array_equal(sa, np.asarray(sa1))
    assert np.array_equal(bwt, np.asarray(bwt1))


def test_mesh_sizes():
    for d in (1, 2, 4):
        mesh = make_mesh(d)
        text = random_string(128, 4, seed=d)
        sa1, _isa, bwt1 = suffix_array(text, 4)
        sad, _r, bwtd = sharded_bwt(text, 4, mesh)
        np.testing.assert_array_equal(sad, sa1)
        np.testing.assert_array_equal(bwtd, bwt1)


def test_engine_sharded_mode(tmp_path, mesh8):
    from bwtb3m.engine import BwtOptions, check_bwt, compute_bwt
    data = bytes((random_string(2048, 4, seed=3) + 97).astype(np.uint8))
    inp = tmp_path / "sh.bin"
    inp.write_bytes(data)
    res = compute_bwt(BwtOptions(input_path=str(inp), engine="sharded",
                                 preisa_sampling_rate=256, verbose=0))
    text = np.frombuffer(data, np.uint8).astype(np.int32)
    assert check_bwt(res, text)
    np.testing.assert_array_equal(res.load_bwt(), naive_bwt(text))


def test_sharded_ragged_length():
    # n % D != 0: pad-slot design (real genome lengths won't
    # divide the mesh size)
    import numpy as np
    from bwtb3m.ops.doubling import suffix_array
    from bwtb3m.parallel import make_mesh, sharded_bwt
    rng = np.random.default_rng(3)
    for n in (1003, 4097, 65535, 77):
        text = rng.integers(0, 4, n, dtype=np.int32)
        sa, rank, bwt = sharded_bwt(text, 4, make_mesh(8))
        sa1, _isa, bwt1 = suffix_array(text, 4)
        assert np.array_equal(sa, np.asarray(sa1)), n
        assert np.array_equal(bwt, np.asarray(bwt1)), n
