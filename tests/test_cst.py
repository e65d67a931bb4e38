"""Compressed suffix tree (index/cst.py) vs brute-force rotation oracles.

Every navigation primitive is checked against prefix-interval ground
truth: the locus of a string w is exactly the rank interval of rotations
prefixed by w.
"""

import numpy as np
import pytest

from bwtb3m.index.cst import CompressedSuffixTree
from oracle import naive_circular_sa


def _mk(text):
    text = np.asarray(text, dtype=np.int64)
    n = len(text)
    sa = naive_circular_sa(text)
    lcp = np.zeros(n, np.int64)
    for i in range(1, n):
        a, b = sa[i - 1], sa[i]
        l = 0
        while l < n and text[(a + l) % n] == text[(b + l) % n]:
            l += 1
        lcp[i] = l
    return text, sa, lcp, CompressedSuffixTree(lcp, sa=sa, text=text)


def _prefix_interval(text, sa, w):
    """Oracle: inclusive rank interval of rotations prefixed by w."""
    n = len(text)
    hits = []
    for r in range(n):
        p = sa[r]
        if all(text[(p + i) % n] == w[i] for i in range(len(w))):
            hits.append(r)
    if not hits:
        return None
    assert hits == list(range(hits[0], hits[-1] + 1))
    return (hits[0], hits[-1])


@pytest.mark.parametrize("seed,n,sigma", [(1, 40, 3), (2, 60, 2), (3, 80, 4)])
def test_cst_descend_matches_prefix_intervals(seed, n, sigma):
    rng = np.random.default_rng(seed)
    text, sa, lcp, cst = _mk(rng.integers(0, sigma, n))
    for _ in range(40):
        m = int(rng.integers(1, 7))
        w = rng.integers(0, sigma, m)
        got = cst.descend(w)
        want = _prefix_interval(text, sa, list(w))
        if want is None:
            assert got is None
        else:
            assert got is not None
            # the locus interval equals the prefix interval
            assert (got[0], got[1]) == want


def test_cst_children_partition_and_depths():
    rng = np.random.default_rng(7)
    text, sa, lcp, cst = _mk(rng.integers(0, 3, 50))
    n = len(text)
    stack = [cst.root]
    seen_leaves = 0
    while stack:
        v = stack.pop()
        if cst.is_leaf(v):
            seen_leaves += 1
            continue
        kids = cst.children(v)
        assert len(kids) >= 2
        # children partition v in rank order
        assert kids[0][0] == v[0] and kids[-1][1] == v[1]
        for a, b in zip(kids, kids[1:]):
            assert a[1] + 1 == b[0]
        dv = cst.string_depth(v)
        for w in kids:
            dw = cst.string_depth(w) if not cst.is_leaf(w) else n
            assert dw > dv
            # parent of every child is v
            assert cst.parent(w) == v
        stack.extend(kids)
    assert seen_leaves == n


def test_cst_suffix_link():
    rng = np.random.default_rng(11)
    text, sa, lcp, cst = _mk(rng.integers(0, 3, 60))
    n = len(text)
    stack = [cst.root]
    while stack:
        v = stack.pop()
        if cst.is_leaf(v) or v == cst.root:
            if not cst.is_leaf(v):
                stack.extend(cst.children(v))
            continue
        d = cst.string_depth(v)
        # path label of v = first d symbols of rotation sa[l]
        w = [int(text[(sa[v[0]] + i) % n]) for i in range(1, d)]
        slv = cst.suffix_link(v)
        if w:
            want = _prefix_interval(text, sa, w)
            assert slv == want
        else:
            assert slv == cst.root
        stack.extend(cst.children(v))


def test_cst_lca():
    rng = np.random.default_rng(13)
    text, sa, lcp, cst = _mk(rng.integers(0, 2, 40))
    n = len(text)
    for _ in range(60):
        a, b = sorted(rng.integers(0, n, 2))
        u, v = (int(a), int(a)), (int(b), int(b))
        g = cst.lca(u, v)
        if a == b:
            assert g == u
            continue
        # oracle: lca interval is the prefix interval of the common prefix
        l = 0
        while l < n and text[(sa[a] + l) % n] == text[(sa[b] + l) % n]:
            l += 1
        w = [int(text[(sa[a] + i) % n]) for i in range(l)]
        if w:
            assert g == _prefix_interval(text, sa, w)
        else:
            assert g == cst.root


def test_cst_from_files(tmp_path):
    # end-to-end through the suite's own outputs (.ulcp/.rmm/.sa rate 1)
    from bwtb3m.io import formats
    from bwtb3m.lcp.rmm import RMMTree
    from bwtb3m.lcp.wavelet_lcp import write_ulcp

    rng = np.random.default_rng(17)
    text, sa, lcp, _ = _mk(rng.integers(0, 3, 30))
    base = str(tmp_path / "t")
    write_ulcp(base + ".ulcp", lcp)
    RMMTree(lcp).write(base + ".rmm")
    formats.write_sampled_array(base + ".sa", 1, sa.astype(np.int64))
    cst = CompressedSuffixTree.from_files(base)
    cst.text = text
    got = cst.descend(np.array([int(text[0])]))
    assert got == _prefix_interval(text, sa, [int(text[0])])
