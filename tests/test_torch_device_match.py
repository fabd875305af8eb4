"""Port parity: ``trex_tpu_torch.ops.device_match.auction_match`` against
the JAX package's ``trex_tpu.ops.device_match.auction_match`` on the CPU:
random (F, B) probability matrices (F in 8, 32, 64), some quantised to
hold exact ties (``tests/test_device_match.py``'s fuzz), and matrices
whose bidding crawls to the iteration cap.

Equal: the fish-of-blob assignment and the marginal flag, exactly. The
auction's prices are float32 sums taken in the same order in both
packages; the certificate's primal and dual sums are reductions whose
order may differ, which the 1e-3 gap guard is far wider than. Where the
flag is clear, the assignment is also the host matcher's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trex_tpu.ops.device_match import auction_match as jax_auction
from trex_tpu.ops.device_tracker import launch_resilient
from trex_tpu.track.matching import PairedProbabilities, match
from trex_tpu_torch.ops.device_match import (AUCTION_BLOCK, ITER_CAP,
                                             _n_squarings, auction_match)

from test_torch_engine import one_torch_thread  # noqa: F401

P_MIN = 0.1


def instances(F, seed, n, quantize):
    rng = np.random.default_rng(seed)
    B = F + 8        # one shape per F: the JAX function compiles once
    for _ in range(n):
        used = int(rng.integers(max(1, F // 2), B + 1))
        density = rng.uniform(0.05, 0.5)
        Pm = np.zeros((F, B), np.float32)
        mask = rng.random((F, B)) < density
        mask[:, used:] = False
        Pm[mask] = rng.uniform(0.0, 1.0, mask.sum()).astype(np.float32)
        if quantize:
            Pm = (np.round(Pm * 8) / 8).astype(np.float32)
        yield Pm


def host_assign(Pm):
    pp = PairedProbabilities()
    fi, bi = np.nonzero(Pm > P_MIN)
    for f, b in zip(fi.tolist(), bi.tolist()):
        pp.add(("f", f), ("b", b), float(np.float64(Pm[f, b])))
    return {b[1]: f[1] for b, f in match(pp, "automatic").pairings.items()}


@pytest.fixture(scope="module")
def jax_fn():
    return jax.jit(jax_auction)


@pytest.mark.parametrize("F", [8, 32, 64])
@pytest.mark.parametrize("quantize", [False, True])
def test_auction_equals_jax(jax_fn, F, quantize):
    total = flagged = 0
    for Pm in instances(F, 7 * F + quantize, 12, quantize):
        ok = Pm > P_MIN
        fob_r, marg_r = launch_resilient(jax_fn, jnp.asarray(Pm),
                                         jnp.asarray(ok))
        fob, marg = auction_match(torch.as_tensor(Pm), torch.as_tensor(ok))
        np.testing.assert_array_equal(fob.numpy(), np.asarray(fob_r))
        assert bool(marg) == bool(marg_r)
        total += 1
        if bool(marg):
            flagged += 1
            continue
        fob = fob.numpy()
        assert {j: int(fob[j]) for j in range(len(fob)) if fob[j] >= 0} \
            == host_assign(Pm)
    if not quantize:
        assert flagged < total


def crawl_matrix(F=3, B=2):
    """More fish than blobs, every value equal: the prices crawl up by
    eps a round, far past the iteration cap."""
    return np.full((F, B), 0.5, np.float32)


@pytest.mark.parametrize("cap", [ITER_CAP, 100])
def test_cap_hit_ends_in_the_reference_state(cap):
    Pm = crawl_matrix()
    ok = Pm > P_MIN
    fob_r, marg_r = jax_auction(jnp.asarray(Pm), jnp.asarray(ok),
                                iter_cap=cap)
    stats = {}
    fob, marg = auction_match(torch.as_tensor(Pm), torch.as_tensor(ok),
                              iter_cap=cap, stats=stats)
    np.testing.assert_array_equal(fob.numpy(), np.asarray(fob_r))
    assert bool(marg) and bool(marg_r)
    assert stats["cap_hit"] and int(stats["rounds"]) == cap
    assert ITER_CAP % AUCTION_BLOCK == 0


def test_converged_auction_stops_counting_rounds():
    """Rounds after the last bidder are no-ops: the blocks overrun the
    converged auction without changing the answer."""
    Pm = np.array([[0.9, 0.15], [0.16, 0.0]], np.float32)
    stats = {}
    fob, marg = auction_match(torch.as_tensor(Pm),
                              torch.as_tensor(Pm > P_MIN), stats=stats)
    assert fob.tolist() == [0, -1] and not bool(marg)
    assert 0 < int(stats["rounds"]) < AUCTION_BLOCK
    assert not stats["cap_hit"]
    assert [_n_squarings(f) for f in (1, 2, 3, 64, 65)] == [1, 1, 2, 6, 7]
