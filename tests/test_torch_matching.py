"""Port parity: ``trex_tpu_torch.track.matching.match`` against the JAX
package's ``trex_tpu.track.matching.match`` in the optimal modes
(``hungarian``, ``tree``, ``automatic``) and ``approximate``, on random
sparse probability graphs: large and small cliques, quantised
probabilities that tie, edges exactly at p_min and singletons. The
pairings must be equal (both packages run the same float64 arithmetic
on the same values)."""
import numpy as np
import pytest

from trex_tpu.track.matching import PairedProbabilities as JaxPaired
from trex_tpu.track.matching import match as jax_match
from trex_tpu_torch.track.matching import PairedProbabilities, match

P_MIN = 0.1
MODES = ["hungarian", "tree", "automatic", "approximate"]


def graphs(seed, max_fish=24, n=40):
    """Random edge lists [(fish, blob, p)] in insertion order. Few blobs
    keep every tree search far inside its time budget, so that no
    result depends on the clock."""
    rng = np.random.default_rng(seed)
    for trial in range(n):
        nf = int(rng.integers(1, max_fish))
        nb = int(rng.integers(1, 10))
        density = rng.uniform(0.05, 0.6)
        edges = []
        for f in range(nf):
            for b in range(nb):
                if rng.random() < density:
                    p = float(rng.uniform(P_MIN, 1.0))
                    if trial % 3 == 1:
                        p = round(p * 4) / 4 or P_MIN   # ties
                    if trial % 5 == 2 and rng.random() < 0.2:
                        p = P_MIN                        # the p_min edge
                    edges.append((f, b, p))
        # a singleton fish and a singleton blob pair
        edges.append((nf + 1, nb + 1, 0.5))
        yield edges


def _paired(cls, edges):
    pp = cls()
    for f, b, p in edges:
        pp.add(("f", f), ("b", b), p)
    return pp


@pytest.mark.parametrize("mode", MODES)
def test_match_equals_jax(mode):
    n_multi = 0
    for edges in graphs(MODES.index(mode), 12 if mode == "tree" else 24):
        ref = jax_match(_paired(JaxPaired, edges), mode=mode)
        got = match(_paired(PairedProbabilities, edges), mode=mode)
        assert got.pairings == ref.pairings, edges
        assert got.mode == mode
        pp = _paired(PairedProbabilities, edges)
        n_multi += sum(len(f) > 8 for f, _ in pp.cliques())
        assert sorted(map(sorted, pp.cliques())) == sorted(
            map(sorted, _paired(JaxPaired, edges).cliques()))
    # cliques above automatic's tree limit took the Hungarian path
    assert n_multi > 0 or mode == "tree"


def test_tie_break_and_weight_over_cardinality():
    """A dominant edge beats two weaker ones (max sum, not max
    cardinality), and exact ties break as in the JAX package."""
    edges = [(0, 0, 0.9), (0, 1, 0.15), (1, 0, 0.16)]
    for mode in ("hungarian", "tree", "automatic"):
        got = match(_paired(PairedProbabilities, edges), mode=mode)
        assert got.pairings == {("b", 0): ("f", 0)}
    tied = [(0, 0, 0.5), (0, 1, 0.5), (1, 0, 0.5), (1, 1, 0.5),
            (2, 1, 0.5)]
    for mode in MODES:
        assert match(_paired(PairedProbabilities, tied), mode).pairings \
            == jax_match(_paired(JaxPaired, tied), mode).pairings


def test_benchmark_mode_is_not_ported(capsys):
    """match_mode=benchmark, which the object Tracker now takes: the
    pairings, the disagreement count and the warnings equal the JAX
    package's, and each algorithm counts its samples; an unknown mode
    still raises."""
    from trex_tpu.track import matching as jax_matching
    from trex_tpu_torch.track import matching

    jax_matching.reset_benchmarks()
    matching.reset_benchmarks()
    for edges in list(graphs(11, 12, n=12)) + [
            [(0, 0, 0.9), (0, 1, 0.8), (1, 0, 0.85), (1, 1, 0.1)]]:
        ref = jax_match(_paired(JaxPaired, edges), mode="benchmark")
        want = capsys.readouterr().out
        got = match(_paired(PairedProbabilities, edges), mode="benchmark")
        assert capsys.readouterr().out == want
        assert got.pairings == ref.pairings
        assert got.improvements_made == ref.improvements_made
    assert got.improvements_made == 2 and "individual ('f', 0)" in want
    assert {k: v.samples for k, v in matching.BENCHMARKS.items()} \
        == {k: v.samples for k, v in jax_matching.BENCHMARKS.items()} \
        == {"hungarian": 13, "tree": 13, "approximate": 13}
    assert [line.split(":")[0] for line in matching.benchmark_report()] \
        == ["approximate", "hungarian", "tree"]
    matching.reset_benchmarks()
    jax_matching.reset_benchmarks()
    assert matching.benchmark_report() == []
    with pytest.raises(ValueError, match="match_mode"):
        match(_paired(PairedProbabilities, [(0, 0, 0.5)]), "sideways")
