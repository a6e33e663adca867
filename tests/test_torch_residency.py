"""ops/residency.py of the port against the JAX package, bitwise: the
slim and i32 decision packs byte for byte, the sparse row correction
(pad rows dropped, never landing on row N-1), the port insertion and its
host replay, the transfer-size models; and the node cache's
dynamic-leaf delta protocol that device residency rides on."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.ops import residency as JR
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.encode import NodeFeatureCache
from minisched_tpu_torch.ops import residency as R
from minisched_tpu_torch.state import objects as TO
from torch_parity import bits_equal, ports_case


def _decision(P, F=3, seed=7):
    rng = np.random.default_rng(seed + P)
    return (rng.integers(-1, 60_000, P).astype(np.int32),
            rng.random(P) > 0.4, rng.random(P) > 0.8,
            rng.integers(0, 70_000, P).astype(np.int32),
            rng.integers(0, 70_000, P).astype(np.int32),
            rng.integers(0, 70_000, (F, P)).astype(np.int32),
            rng.random(P) > 0.9)


@pytest.mark.parametrize("P", [13, 16, 24, 1024])
def test_pack_decision_slim_bytes_match_jax(P):
    planes = _decision(P)
    want = np.asarray(JR.pack_decision_slim(*map(jnp.asarray, planes)))
    got = R.pack_decision_slim(*map(torch.from_numpy, planes)).numpy()
    assert got.dtype == np.uint8
    assert bits_equal(want, got)
    assert got.nbytes == R.slim_buffer_bytes(P, 3) == JR.slim_buffer_bytes(
        P, 3)
    out = R.unpack_decision_slim(got.copy(), P, 3)
    sat = [planes[0], planes[1], planes[2],
           *(np.minimum(x, R.I16_SAT) for x in planes[3:6]), planes[6]]
    for o, w in zip(out, sat):
        assert np.array_equal(o, w)
    for o, w in zip(out, JR.unpack_decision_slim(want.copy(), P, 3)):
        assert bits_equal(w, o)


@pytest.mark.parametrize("P", [13, 16])
def test_pack_decision_i32_matches_jax(P):
    planes = _decision(P)
    want = np.asarray(JR.pack_decision_i32(*map(jnp.asarray, planes)))
    got = R.pack_decision_i32(*map(torch.from_numpy, planes)).numpy()
    assert bits_equal(want, got)
    for o, w in zip(R.unpack_decision_i32(got.copy()),
                    JR.unpack_decision_i32(want.copy())):
        assert bits_equal(w, o)


@pytest.mark.parametrize("n", [0, 1, 5, 16, 17])
def test_apply_rows_matches_jax_and_spares_row_n_minus_1(n):
    """Rows padded to the power-of-two bucket; the pad rows (the
    out-of-range sentinel the JAX scatter drops) touch nothing, the last
    row least of all."""
    rng = np.random.default_rng(n)
    N = 40
    state = rng.random((N, 4)).astype(np.float32)
    rows = rng.choice(N - 1, n, replace=False).astype(np.int32)
    vals = rng.random((n, 4)).astype(np.float32)
    want = np.asarray(JR.apply_rows(jnp.asarray(state), rows, vals))
    for donate in (False, True):
        t = torch.from_numpy(state.copy())
        got = R.apply_rows(t, rows, vals, donate=donate)
        assert bits_equal(want, got.numpy())
        assert bits_equal(got.numpy()[N - 1], state[N - 1])
        assert (got is t) == donate
    assert R.apply_rows_bytes(n, vals) == JR.apply_rows_bytes(n, vals)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_ports_matches_jax_and_host_replay(seed):
    state, rows, ports = ports_case(np.random.default_rng(seed))
    want = np.asarray(JR.insert_ports(jnp.asarray(state), rows, ports))
    got = R.insert_ports(torch.from_numpy(state), rows, ports).numpy()
    assert bits_equal(want, got)
    assert not bits_equal(got, state)  # the case inserts something
    mirror = state.copy()
    R.replay_ports_host(mirror, rows, ports)
    jmirror = state.copy()
    JR.replay_ports_host(jmirror, rows, ports)
    assert bits_equal(mirror, got) and bits_equal(jmirror, got)
    assert R.insert_ports_bytes(*ports.shape) == JR.insert_ports_bytes(
        *ports.shape)


def test_insert_ports_rule():
    """First zero slot per nonzero port, pod order, duplicates written
    twice, overflow dropped, -1 rows skipped (the JAX package's case)."""
    state = np.zeros((6, 4), dtype=np.int32)
    state[2] = [80, 0, 443, 0]
    state[5] = [1, 2, 3, 4]
    rows = np.array([2, 2, 5, -1, 0], dtype=np.int32)
    ports = np.array([[8080, 0, 0], [8080, 9090, 0], [7070, 0, 0],
                      [1234, 0, 0], [0, 0, 0]], dtype=np.int32)
    got = R.insert_ports_plain(*(torch.from_numpy(a)
                                 for a in (state, rows, ports))).numpy()
    assert got[2].tolist() == [80, 8080, 443, 8080]
    assert got[5].tolist() == [1, 2, 3, 4]
    assert not got[0].any() and not got[3].any()


# ---- the cache's dynamic-leaf delta protocol, both packages ----------


def _node(O, name, cpu=1000):
    return O.Node(metadata=O.ObjectMeta(name=name), spec=O.NodeSpec(),
                  status=O.NodeStatus(allocatable={
                      "cpu": cpu, "memory": 1 << 30, "pods": 100}))


def _pod(O, name, cpu=100, host_port=0):
    ports = [O.ContainerPort(host_port=host_port)] if host_port else []
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default"),
                 spec=O.PodSpec(requests={"cpu": cpu}, ports=ports))


def _delta_stream(cache_cls, O):
    """One op sequence on a cache: first collection, bind, clean cycle,
    unbind, pad change, delta again, invalidate. Returns what each
    collection handed back."""
    cache = cache_cls()
    for i in range(4):
        cache.upsert_node(_node(O, f"m{i}"))
    lst = cache.register_dyn_listener()
    out = []

    def collect(pad):
        nf, _n, _sv, _i, d = cache.snapshot_resident(pad=pad, dyn=lst)
        if d is None:
            out.append(("full", nf.free.copy(), nf.used_ports.copy()))
        else:
            out.append(("delta", d.epoch, d.rows.copy(), d.free.copy(),
                        d.used_ports.copy()))

    collect(16)
    cache.account_bind(_pod(O, "a", cpu=250, host_port=8080), node_name="m2")
    collect(16)
    collect(16)
    cache.account_unbind("default/a")
    collect(16)
    collect(32)  # pad change: a rebase at the new pad
    cache.account_bind(_pod(O, "b", cpu=100), node_name="m1")
    collect(32)
    lst.invalidate()
    collect(32)
    return out


def test_delta_protocol_matches_jax_cache():
    want = _delta_stream(JCache, JO)
    got = _delta_stream(NodeFeatureCache, TO)
    assert [g[0] for g in got] == ["full", "delta", "delta", "delta",
                                   "full", "delta", "full"]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w[0] == g[0]
        for a, b in zip(w[1:], g[1:]):
            if isinstance(a, np.ndarray):
                assert bits_equal(a, b)
            else:
                assert a == b
    # the bind's row, with its port, travelled in the first delta
    assert got[1][2].tolist() == [2] and 8080 in got[1][4][0]
    assert got[2][2].size == 0  # clean cycle: empty delta, epoch moves
