"""The port's white-data filter (``repro_torch.core.whitedata``, tensor
passes over a group's batch) against the reference's
``filter_group_batch`` on the CPU: ``FilterStats`` field for field, the
kept updates in order and the aborted transactions, with each rule alone
and all four together, on random epochs that fire every rule (stale
versions against the snapshot, repeated content, rewrites of the
snapshot's values), and on an adversarial dedup order where a later update
carries a smaller version.  Neither side imports JAX here.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import crdt as rcrdt
from repro.core import occ as rocc
from repro.core import whitedata as rwd
from repro_torch.core import crdt as pcrdt
from repro_torch.core import occ as pocc
from repro_torch.core import whitedata as pwd

from test_torch_wan_occ import VB, port_txns, random_epoch, snapshot_pair

RULES = ("abort", "dedup", "stale", "null")


def vtuple(v) -> tuple:
    return (v.epoch, v.seq, v.node)


def run_both(txns, ref_snap, table, **flags):
    want = rwd.filter_group_batch(txns, ref_snap, **flags)
    batch = pocc.EpochBatch.from_txns(port_txns(txns), table)
    got = pwd.filter_group_batch(batch, table, **flags)
    kept = [(u.key, u.value, vtuple(u.version), u.txn_id) for u in batch.updates(table, got.kept)]
    want_kept = [(u.key, u.value, vtuple(u.version), u.txn_id) for u in want.kept]
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert kept == want_kept
    assert set(batch.txn_id[got.aborted].tolist()) == want.aborted_txns
    return got.stats


def epoch_with_rewrites(rng, ref_snap, **kw) -> list:
    """A random epoch whose writes sometimes carry the snapshot's current
    value (the null rule) and whose versions straddle the snapshot's (the
    stale rule: epochs 1 and 2 against a snapshot at epoch 1)."""
    txns = random_epoch(rng, epochs=2, values=6, **kw)
    out = []
    for t in txns:
        ws = tuple((k, ref_snap.get(k) if ref_snap.get(k) is not None and rng.random() < 0.3 else v)
                   for k, v in t.write_set)
        out.append(dataclasses.replace(t, write_set=ws))
    return out


@pytest.mark.parametrize("rule", RULES + ("all", "none"))
def test_filter_matches_the_reference_rule_by_rule(rule):
    rng = np.random.default_rng(RULES.index(rule) if rule in RULES else 9)
    flags = {f"enable_{r}": rule == "all" or r == rule for r in RULES}
    fired = []
    for trial in range(6):
        ref_snap, table = snapshot_pair(rng)
        txns = epoch_with_rewrites(rng, ref_snap, collisions=bool(trial % 2))
        stats = run_both(txns, ref_snap, table, **flags)
        fired.append(stats)
    totals = {f: sum(getattr(s, f) for s in fired)
              for f in ("aborted_updates", "duplicate_updates", "stale_updates", "null_updates")}
    for r, field in zip(RULES, ("aborted_updates", "duplicate_updates", "stale_updates",
                                "null_updates")):
        # with the abort rule on, dedup cannot fire within a group: two
        # writers of a key conflict, and all but the first-writer-wins one
        # abort (a transaction writes a key once)
        expect = flags[f"enable_{r}"] and not (r == "dedup" and flags["enable_abort"])
        assert (totals[field] > 0) == expect, (r, totals)


def test_every_flag_combination():
    rng = np.random.default_rng(21)
    ref_snap, table = snapshot_pair(rng)
    txns = epoch_with_rewrites(rng, ref_snap, n_txns=40)
    for bits in itertools.product((False, True), repeat=4):
        run_both(txns, ref_snap, table, **{f"enable_{r}": b for r, b in zip(RULES, bits)})


def test_dedup_is_a_running_minimum_in_update_order():
    """Same (key, value) from three transactions, listed with versions 5,
    3, 4 (a later update with a smaller version, from another node): the
    first is kept, the second is kept and lowers the minimum, the third
    is a duplicate of it; so is the same content at version 3 again."""
    v = b"\x07" * VB
    txns = [rocc.Txn(1, 0, 5, 0, (), (("k20", v),)),
            rocc.Txn(2, 1, 3, 0, (), (("k20", v),)),
            rocc.Txn(3, 2, 4, 0, (), (("k20", v),)),
            rocc.Txn(4, 1, 3, 0, (), (("k20", v),))]
    ref_snap, table = rcrdt.DeltaCRDTStore(), pcrdt.CRDTTable(24, VB, device="cpu")
    stats = run_both(txns, ref_snap, table, enable_abort=False)
    assert (stats.kept_updates, stats.duplicate_updates) == (2, 2)
    # with the abort rule on, every writer but the first-writer-wins one aborts
    stats = run_both(txns, ref_snap, table)
    assert (stats.kept_updates, stats.aborted_updates) == (1, 3)


def test_no_filter_passes_everything():
    rng = np.random.default_rng(5)
    ref_snap, table = snapshot_pair(rng)
    txns = random_epoch(rng)
    want = rwd.no_filter(txns, ref_snap)
    batch = pocc.EpochBatch.from_txns(port_txns(txns), table)
    got = pwd.no_filter(batch, table)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.stats.wire_bytes == want.stats.wire_bytes and bool(got.kept.all())
    assert pwd.white_ratio(got.stats) == rwd.white_ratio(want.stats) == 0.0


def test_filter_stats_algebra():
    a = pwd.FilterStats(10, 1000, 6, 500, 2, 200, 1, 100, 1, 100, 2, 40)
    b = rwd.FilterStats(10, 1000, 6, 500, 2, 200, 1, 100, 1, 100, 2, 40)
    m = a.merge(a)
    assert dataclasses.asdict(m) == dataclasses.asdict(b.merge(b))
    assert (a.white_bytes, a.white_byte_ratio, a.white_update_ratio, a.wire_bytes) == \
        (b.white_bytes, b.white_byte_ratio, b.white_update_ratio, b.wire_bytes)
