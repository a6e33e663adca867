"""ops/prng.py draws JAX's threefry keys and bits bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minisched_tpu_torch.ops import prng

SEEDS = [0, 1, 7, 42, 123456789, 2**31 - 1, 2**31, 2**31 + 12345,
         3_000_000_000, 2**32 - 1]


def _jax_draws(seed, counters):
    base = jax.random.PRNGKey(seed)

    def one(c):
        k = jax.random.fold_in(base, c)
        return jax.random.key_data(k), jax.random.bits(k, (), jnp.uint32)

    keys, bits = jax.jit(jax.vmap(one))(jnp.asarray(counters, jnp.uint32))
    return np.asarray(keys), np.asarray(bits)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_bits_match_jax(seed):
    """>= 2,000 (seed, counter) pairs over the parametrization, counters
    from 0 up and a few beyond 2^31."""
    counters = list(range(250)) + [2**31 - 1, 2**31, 2**32 - 1]
    keys, bits = _jax_draws(seed, counters)
    base = prng.PRNGKey(seed)
    for j, c in enumerate(counters):
        k = prng.fold_in(base, c)
        assert k == (int(keys[j, 0]), int(keys[j, 1])), (seed, c)
        assert prng.bits(k) == int(bits[j]), (seed, c)


def test_prngkey_matches_jax():
    for seed in SEEDS:
        want = tuple(int(x) for x in jax.random.key_data(
            jax.random.PRNGKey(seed)))
        assert prng.PRNGKey(seed) == want


def test_threefry_partitionable_mode():
    """The port reproduces the partitionable bits layout; the reference
    must be running in that mode for the parity above to mean it."""
    assert jax.config.jax_threefry_partitionable


def _key_words(k):
    return tuple(int(x) for x in jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 5, 2**32 - 1])
def test_split_matches_jax(seed):
    """jax.random.split, as the sampled step calls it, over 4,096 keys
    per seed (fold_in of the counters 0..4095)."""
    base = jax.random.PRNGKey(seed)

    def one(c):
        a, b = jax.random.split(jax.random.fold_in(base, c))
        return jax.random.key_data(a), jax.random.key_data(b)

    counters = jnp.arange(4096, dtype=jnp.uint32)
    ka, kb = (np.asarray(x) for x in jax.jit(jax.vmap(one))(counters))
    pbase = prng.PRNGKey(seed)
    for c in range(4096):
        a, b = prng.split(prng.fold_in(pbase, c))
        assert a == (int(ka[c, 0]), int(ka[c, 1])), (seed, c)
        assert b == (int(kb[c, 0]), int(kb[c, 1])), (seed, c)
    assert len(prng.split(pbase, 5)) == 5
    assert [_key_words(k) for k in jax.random.split(base, 5)] == list(
        prng.split(pbase, 5))


@pytest.mark.parametrize("maxval", [0.05, 1.0, 3.0])
def test_uniform_matches_jax(maxval):
    """jax.random.uniform(key, (n,), maxval=...) bitwise over 4,096 keys
    (the sample's jitter is maxval=0.05), each drawing 97 values, and one
    key drawing 53,248 (the bench cluster's node pad)."""
    base = jax.random.PRNGKey(11)

    def one(c):
        return jax.random.uniform(jax.random.fold_in(base, c), (97,),
                                  maxval=maxval)

    want = np.asarray(jax.jit(jax.vmap(one))(
        jnp.arange(4096, dtype=jnp.uint32)))
    pbase = prng.PRNGKey(11)
    got = np.stack([prng.uniform(prng.fold_in(pbase, c), 97, maxval).numpy()
                    for c in range(4096)])
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= 0.0 and got.max() < maxval
    key = jax.random.fold_in(base, 77)
    wide = np.asarray(jax.random.uniform(key, (53248,), maxval=maxval))
    assert np.array_equal(
        prng.uniform(_key_words(key), 53248, maxval).numpy().view(np.int32),
        wide.view(np.int32))
