"""BWT layer tests: device forward/inverse, oracle cross-check, round-trips
(ref capabilities: c-sources/divsufsort.c divbwt/construct_BWT,
utils.c bw_transform/inverse_bw_transform)."""

import numpy as np

from stringsearch_tpu import oracle
from stringsearch_tpu.transforms import bwt, divbwt, unbwt


def test_bwt_matches_oracle(corpus):
    for name, data in corpus.items():
        if not data:
            continue
        u_t, pidx_t = divbwt(data)
        u_c, pidx_c = oracle.bwt(data)
        assert u_t == u_c, f"bwt mismatch on {name!r}"
        assert pidx_t == pidx_c, f"pidx mismatch on {name!r}"


def test_roundtrip_device_both_ways(corpus):
    for name, data in corpus.items():
        u, pidx = divbwt(data)
        assert unbwt(u, pidx) == data, f"device roundtrip failed on {name!r}"


def test_cross_roundtrip():
    """Device forward + oracle inverse and vice versa — conventions must agree."""
    rng = np.random.default_rng(2)
    data = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    u_t, pidx_t = divbwt(data)
    assert oracle.unbwt(u_t, pidx_t) == data
    u_c, pidx_c = oracle.bwt(data)
    assert unbwt(u_c, pidx_c) == data


def test_banana():
    u, pidx = divbwt(b"banana")
    assert u == b"annbaa" and pidx == 3


def test_empty_and_single():
    assert divbwt(b"") == (b"", 0)
    assert unbwt(b"", 0) == b""
    u, pidx = divbwt(b"z")
    assert unbwt(u, pidx) == b"z"


def test_divbwt_fused_matches_two_step():
    """The one-program fused divbwt must equal SA-then-bwt_from_sa and
    the host oracle."""
    import jax.numpy as jnp

    from stringsearch_tpu import oracle
    from stringsearch_tpu.engines.doubling import sort as dsort
    from stringsearch_tpu.transforms.bwt import _divbwt_fused, bwt_from_sa

    data = (b"the quick brown fox " * 40) + bytes(range(256))
    arr = np.frombuffer(data, dtype=np.uint8)
    u_f, pidx_f = _divbwt_fused(jnp.asarray(arr), 12)
    sa = dsort(data)
    u_2, pidx_2 = bwt_from_sa(sa.text, sa.sa)
    assert int(pidx_f) == int(pidx_2)
    assert np.array_equal(np.asarray(u_f), np.asarray(u_2))
    want_u, want_p = oracle.bwt(data)
    assert int(pidx_f) == want_p
    assert bytes(np.asarray(u_f).tobytes()) == want_u
