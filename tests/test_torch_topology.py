"""The port's topology math against the JAX package's, bitwise on the
same numpy leaves: the dense matchers (ops/matchers.py), the group
topology tables (ops/topology.py) and the in-scan domain caps
(ops/spreadcap.py: build_domain_caps, caps_mask, caps_update), over
random clusters drawn with hypothesis."""
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from minisched_tpu.encode import features as JF
from minisched_tpu.ops import matchers as jm
from minisched_tpu.ops import spreadcap as jsc
from minisched_tpu.ops.topology import (gather_group_rows as jgather,
                                        group_assigned_match as jmatch,
                                        group_topology_state as jtopo)
from minisched_tpu_torch.encode import to_torch
from minisched_tpu_torch.ops import matchers as tm
from minisched_tpu_torch.ops import spreadcap as tsc
from minisched_tpu_torch.ops.topology import (gather_group_rows,
                                              group_assigned_match,
                                              group_topology_state)
from test_torch_plugins_full import encode_both
from torch_parity import bits_equal, full_cluster

SETTINGS = settings(max_examples=12, deadline=None)


def _batch(seed, n_nodes=48, n_pods=32, hard=True):
    return encode_both(lambda O: full_cluster(O, n_nodes, n_pods, seed,
                                              hard=hard), p_pad=32)


def _t(x):
    return to_torch(x, "cpu")


@SETTINGS
@given(seed=st.integers(0, 2 ** 16))
def test_matchers_match_jax(seed):
    (jeb, jnf, _, _), (teb, tnf, _, _) = _batch(seed)
    eb, nf = _t(teb), _t(tnf)
    naf, jnaf = eb.naf, jeb.naf
    pairs = [
        (jm.pairs_subset(jnaf.sel_pairs, jnf.label_pairs),
         tm.pairs_subset(naf.sel_pairs, nf.label_pairs)),
        (jm.term_matches(jnaf.req_op, jnaf.req_key, jnaf.req_vals,
                         jnf.label_pairs, jnf.label_keys),
         tm.term_matches(naf.req_op, naf.req_key, naf.req_vals,
                         nf.label_pairs, nf.label_keys)),
        (jm.term_matches(jnaf.pref_op, jnaf.pref_key, jnaf.pref_vals,
                         jnf.label_pairs, jnf.label_keys),
         tm.term_matches(naf.pref_op, naf.pref_key, naf.pref_vals,
                         nf.label_pairs, nf.label_keys)),
        (jm.tolerations_cover(jeb.pf, jnf.taint_pairs, jnf.taint_keys,
                              jnf.taint_effects,
                              (JF.EFFECT_NO_SCHEDULE, JF.EFFECT_NO_EXECUTE)),
         tm.tolerations_cover(eb.pf, nf.taint_pairs, nf.taint_keys,
                              nf.taint_effects,
                              (JF.EFFECT_NO_SCHEDULE, JF.EFFECT_NO_EXECUTE))),
        (jm.untolerated_count(jeb.pf, jnf.taint_pairs, jnf.taint_keys,
                              jnf.taint_effects,
                              JF.EFFECT_PREFER_NO_SCHEDULE),
         tm.untolerated_count(eb.pf, nf.taint_pairs, nf.taint_keys,
                              nf.taint_effects,
                              JF.EFFECT_PREFER_NO_SCHEDULE)),
    ]
    for want, got in pairs:
        assert bits_equal(np.asarray(want), got.numpy())


@SETTINGS
@given(seed=st.integers(0, 2 ** 16), hard=st.booleans())
def test_group_topology_state_matches_jax(seed, hard):
    (jeb, jnf, jaf, _), (teb, tnf, taf, _) = _batch(seed, hard=hard)
    eb, nf, af = _t(teb), _t(tnf), _t(taf)
    assert bits_equal(np.asarray(jmatch(jeb.gf, jaf)),
                      group_assigned_match(eb.gf, af).numpy())
    num = max(jnf.valid.shape[0], 4096)
    want = jtopo(jnf, jaf, jeb.gf, num)
    got = group_topology_state(nf, af, eb.gf, num)
    assert sorted(want) == sorted(got)
    for k in want:
        assert bits_equal(np.asarray(want[k]), got[k].numpy()), k
    assert np.asarray(want["counts_dom"]).sum() > 0
    for fill in (0.0, 1.0):
        assert bits_equal(
            np.asarray(jgather(jeb.pf.spread_group[:, 0],
                               want["counts_node"], fill)),
            gather_group_rows(eb.pf.spread_group[:, 0], got["counts_node"],
                              fill).numpy())


def _caps_both(seed, n_nodes, hard=True, max_domains=128):
    (jeb, jnf, jaf, _), (teb, tnf, taf, _) = _batch(seed, n_nodes=n_nodes,
                                                    hard=hard)
    eb, nf, af = _t(teb), _t(tnf), _t(taf)
    num = max(jnf.valid.shape[0], 4096)
    jt = jtopo(jnf, jaf, jeb.gf, num)
    tt = group_topology_state(nf, af, eb.gf, num)
    want = jsc.build_domain_caps(jeb.pf, jeb.gf, jnf, jt["counts_dom"],
                                 jt["dom_exists"], max_domains=max_domains)
    got = tsc.build_domain_caps(eb.pf, eb.gf, nf, tt["counts_dom"],
                                tt["dom_exists"], max_domains=max_domains)
    return want, got


@SETTINGS
@given(seed=st.integers(0, 2 ** 16), n_nodes=st.sampled_from([24, 48, 160]),
       hard=st.booleans(), max_domains=st.sampled_from([4, 128]))
def test_build_domain_caps_matches_jax(seed, n_nodes, hard, max_domains):
    """Zone groups compact, hostname groups compact below 128 nodes and
    overflow above (and every group overflows at 4 domains); soft-only
    batches enforce nothing."""
    want, got = _caps_both(seed, n_nodes, hard, max_domains)
    for f in got._fields:
        assert bits_equal(np.asarray(getattr(want, f)),
                          getattr(got, f).numpy()), f
    if not hard:
        assert not bool(got.any_enforced)


@SETTINGS
@given(seed=st.integers(0, 2 ** 16))
def test_caps_mask_and_update_match_jax(seed):
    """caps_mask and caps_update along a walk that places each pod on a
    random node, from the pre-batch counts."""
    want, got = _caps_both(seed, 48)
    rng = np.random.default_rng(seed)
    jc, tc = want.counts0, got.counts0.clone()
    N = got.domc.shape[1]
    for i in range(got.slot_h.shape[0]):
        jmask = jsc.caps_mask(want, jc, jnp.int32(i))
        tmask = tsc.caps_mask(got, tc, i)
        assert bits_equal(np.asarray(jmask), tmask.numpy())
        j = int(rng.integers(0, N))
        jc = jsc.caps_update(want, jc, jnp.int32(i), jnp.int32(j),
                             jnp.bool_(True))
        tc = tsc.caps_update(got, tc, i, j)
        assert bits_equal(np.asarray(jc), tc.numpy())
