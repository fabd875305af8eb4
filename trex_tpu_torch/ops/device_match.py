"""On-device optimal fish <-> blob assignment for the tracking scan.

Counterpart of ``trex_tpu/ops/device_match.py``. The host matchers solve
a max-weight bipartite matching per connected clique (the sum of p over
edges with p > match_min_probability; a fish may stay unassigned when
that raises the sum). Per-clique optima compose, so the card solves the
whole frame at once with a forward auction (Bertsekas): each round every
unassigned fish bids for its best net-value blob (value - price), raising
the price by its margin over its second-best option (staying unassigned
is worth 0), and each contested blob goes to the highest bidder.

The frame defers to the host (``marginal``) unless the answer provably
equals the host's:

- an exact primal-dual gap certifies the optimum up to GAP_GUARD;
- alternative optima (whose choice would be the host's tie-break) need a
  chain of tight edges with cancelling boundary duals: the fish -> fish
  tight-step matrix is closed by repeated squaring and any cycle or
  cancelling path flags the frame; auctions that crawl to ITER_CAP (the
  signature of near-ties) flag too;
- edges within EDGE_GUARD of match_min_probability flag (the float32
  edge set could differ from the host's float64 one).

The reference's ``lax.while_loop`` is a Python loop here that checks for
remaining bidders on the host every AUCTION_BLOCK rounds: once no bidder
remains a round changes nothing, so the extra rounds of a block leave the
state, and ``cap_hit``, as the reference's loop leaves them.
"""
from __future__ import annotations

import torch

NEG = -1e9
EPS_BID = 1e-6       # auction eps: final matching within n*eps of OPT
ITER_CAP = 512       # bidding rounds; crawls (= near-ties) flag
GAP_GUARD = 1e-3     # exact dual-gap certificate threshold
TIE_GUARD = 1e-4     # alternative optimum within this of OPT -> host
EDGE_GUARD = 1e-6    # |p - p_min| boundary band -> host
AUCTION_BLOCK = 8    # rounds between host checks; divides ITER_CAP

_F32 = torch.float32
_I32 = torch.int32


def auction_match(Pmat: torch.Tensor, edge_ok: torch.Tensor,
                  eps: float = EPS_BID, iter_cap: int = ITER_CAP,
                  gap_guard: float = GAP_GUARD, tie_guard=TIE_GUARD,
                  stats: dict = None):
    """Optimal assignment of fish rows to blob columns.

    Pmat: (F, B) float32 probabilities; edge_ok: (F, B) bool, the edges
    the host would consider (p > p_min, fish usable, blob valid);
    `tie_guard` a float or a 0-d tensor.

    Returns (fob (B,) int32 fish of blob or -1, marginal 0-d bool). When
    `marginal` is False the assignment equals the host matcher's; when
    True the caller defers the frame to the host. `stats`, when given,
    receives the rounds that had bidders ("rounds", a 0-d tensor on the
    card) and whether the cap was hit ("cap_hit")."""
    F, B = Pmat.shape
    dev = Pmat.device
    neg = torch.tensor(NEG, dtype=_F32, device=dev)
    V = torch.where(edge_ok, Pmat, neg)
    fish_has_edge = edge_ok.any(1)
    cols = torch.arange(B, device=dev)
    price = torch.zeros(B, dtype=_F32, device=dev)
    owner = torch.full((B,), -1, dtype=_I32, device=dev)
    out = ~fish_has_edge

    def bidders(owner, out):
        return ~out & (_owner_of_fish(owner, F) < 0) & fish_has_edge

    rounds = torch.zeros((), dtype=_I32, device=dev)
    it = 0
    while it < iter_cap and bool(bidders(owner, out).any()):
        for _ in range(min(AUCTION_BLOCK, iter_cap - it)):
            bidder = bidders(owner, out)
            if stats is not None:
                rounds = rounds + bidder.any()
            net = V - price[None, :]
            best = net.amax(1)
            jbest = torch.argmax(net, 1)
            net2 = torch.where(cols[None, :] == jbest[:, None], neg, net)
            second = torch.clamp_min(net2.amax(1), 0.0)  # dummy = 0
            out = out | (bidder & (best <= 0))
            bids = bidder & (best > 0)
            incr = best - second + eps
            bidmat = torch.where(
                bids[:, None] & (cols[None, :] == jbest[:, None]),
                incr[:, None], neg)
            top = bidmat.amax(0)
            winner = torch.argmax(bidmat, 0).to(_I32)
            won = top > NEG * 0.5
            price = torch.where(won, price + top, price)
            owner = torch.where(won, winner, owner)
        it += AUCTION_BLOCK
    # bidders left => the iteration cap was hit (eps-crawl, near-tie)
    cap_hit = bool(bidders(owner, out).any())
    if stats is not None:
        stats["rounds"] = rounds
        stats["cap_hit"] = cap_hit
    matched_b = owner >= 0
    fob = torch.where(matched_b, owner, -1).to(_I32)
    if cap_hit:
        return fob, torch.ones((), dtype=torch.bool, device=dev)
    return fob, _certify(V, price, owner, matched_b, fish_has_edge,
                         edge_ok, gap_guard, tie_guard)


def _certify(V, price, owner, matched_b, fish_has_edge, edge_ok,
             gap_guard, tie_guard):
    """Exact duality-gap certificate and tight alternating-structure tie
    detection for a converged auction. Returns the marginal flag."""
    F, B = V.shape
    dev = V.device
    bidx = torch.arange(B, device=dev)
    own_safe = torch.where(matched_b, owner, 0).long()
    v_matched = torch.where(matched_b, V[own_safe, bidx], 0.0)
    primal = v_matched.sum()

    # mu from the auction prices (feasible by construction), prices on
    # matched blobs; unmatched-blob prices the least feasible given mu
    mu = torch.clamp_min((V - price[None, :]).amax(1), 0.0)
    mu = torch.where(fish_has_edge, mu, 0.0)
    pi_unmatched = torch.clamp_min((V - mu[:, None]).amax(0), 0.0)
    dual = mu.sum() + torch.where(matched_b, price, pi_unmatched).sum()
    marginal = dual - primal > gap_guard

    # An alternative matching differs from ours by disjoint alternating
    # cycles/paths; through the dual (v = mu_f + pi_b - slack) a tie
    # needs every added edge tight and the boundary duals to cancel.
    # Fish f steps along a tight unmatched edge to blob b, displacing
    # b's fish f' (A[f, f']); the closure of A enumerates the chains.
    oof = _owner_of_fish(owner, F)
    f_assigned = oof >= 0
    blob_of = torch.where(f_assigned, oof, 0).long()
    f_free = fish_has_edge & ~f_assigned
    pi = torch.where(matched_b, price, pi_unmatched)
    slack = mu[:, None] + pi[None, :] - V
    own_col = bidx[None, :] == torch.where(f_assigned, oof, -1)[:, None]
    tight = edge_ok & ~own_col & (slack <= tie_guard)
    A = (tight & matched_b[None, :])[:, blob_of] & f_assigned[None, :]
    A = A & ~torch.eye(F, dtype=torch.bool, device=dev)
    reach = A
    for _ in range(_n_squarings(F)):
        rf = reach.to(_F32)
        reach = reach | ((rf @ rf) > 0.5)
    step_or_reach = A | reach
    # (1) alternating cycle
    marginal = marginal | reach.diagonal().any()
    # fish -> unmatched blob through tight steps
    t_un = tight & ~matched_b[None, :]
    reach_fb = t_un | ((step_or_reach.to(_F32) @ t_un.to(_F32)) > 0.5)
    # (2) augmenting: free fish -> free blob
    end_b = pi_unmatched <= tie_guard
    marginal = marginal | ((f_free & (mu <= tie_guard))[:, None]
                           & reach_fb & (~matched_b & end_b)[None, :]).any()
    # (3) re-route: covered fish f0 (its blob freed) -> free blob
    pi_b0 = torch.where(f_assigned, pi[blob_of], NEG)
    cancel = (pi_unmatched[None, :] - pi_b0[:, None]).abs() <= tie_guard
    marginal = marginal | (f_assigned[:, None] & reach_fb
                           & ~matched_b[None, :] & cancel).any()
    # (4) displacement chain ending with a fish dropping to the dummy
    drop_ok = f_assigned & (mu <= tie_guard)
    marginal = marginal | ((f_free & (mu <= tie_guard))[:, None]
                           & step_or_reach & drop_ok[None, :]).any()
    # (5) rotation: covered f0 (pi_b0 ~ 0) -> fk drops (mu_fk ~ 0)
    marginal = marginal | ((f_assigned & (pi_b0.abs() <= tie_guard))[:, None]
                           & step_or_reach & drop_ok[None, :]).any()
    # (6) a free-free edge: the matching is not maximal
    marginal = marginal | (f_free[:, None] & ~matched_b[None, :]
                           & edge_ok).any()
    return marginal


def _n_squarings(F: int) -> int:
    n = 1
    k = 2
    while k < F:
        k *= 2
        n += 1
    return n


def _owner_of_fish(owner: torch.Tensor, F: int) -> torch.Tensor:
    """(B,) blob -> fish ownership to (F,) fish -> blob (or -1). A fish
    owns at most one blob (it bids only while it owns none), so only the
    drop slot F takes several writes."""
    B = owner.shape[0]
    slots = torch.where(owner >= 0, owner, F).long()
    return torch.full((F + 1,), -1, dtype=_I32, device=owner.device) \
        .scatter_(0, slots, torch.arange(B, dtype=_I32,
                                         device=owner.device))[:F]


def edge_boundary_marginal(Pmat: torch.Tensor, usable_f: torch.Tensor,
                           valid_b: torch.Tensor, p_min: float,
                           p_err: torch.Tensor) -> torch.Tensor:
    """True when any candidate edge sits within EDGE_GUARD of the p_min
    edge-inclusion boundary (f32 vs host-f64 edge sets could differ).

    `p_err` ((F, B)) widens the band per edge by a bound on
    |p_f32 - p_f64| over the same carry bits."""
    band = (Pmat - p_min).abs() <= EDGE_GUARD + p_err
    return (band & usable_f[:, None] & valid_b[None, :]).any()
