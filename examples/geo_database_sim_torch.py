"""Geo-distributed database simulation on the PyTorch port: the paper's
evaluation in miniature (``examples/geo_database_sim.py``), its store on the
card.

    PYTHONPATH=src python examples/geo_database_sim_torch.py              # on the card
    PYTHONPATH=src python examples/geo_database_sim_torch.py --device cpu

Replays the paper's 5-node real-world testbed (2 Kalgan + 2 Hohhot + 1 Hong
Kong) under TPC-C (100 warehouses, the paper's four mixes) and YCSB, flat
synchronization (GeoGauss) against GeoCoCo (grouping + TIV relays +
white-data filtering), then GeoCoCo on YCSB with its group 0 aggregator
failed at mid-run.  The replicated store, validation, the filter and the
commit run on ``--device``; the planner and the WAN simulator on the host.
"""

import argparse

import numpy as np

from repro_torch.core.latency import jitter_trace
from repro_torch.core.replication import EngineConfig, GeoCluster
from repro_torch.core.workload import TPCC_MIXES, TPCCConfig, TPCCGenerator, YCSBConfig, \
    YCSBGenerator


def paper_testbed(n_rounds: int, seed: int = 0):
    base = np.array(
        [
            [0.0, 1.5, 8.0, 8.5, 42.0],
            [1.5, 0.0, 8.2, 8.0, 43.0],
            [8.0, 8.2, 0.0, 1.8, 38.0],
            [8.5, 8.0, 1.8, 0.0, 39.0],
            [42.0, 43.0, 38.0, 39.0, 0.0],
        ]
    )
    regions = np.array([0, 0, 1, 1, 2])
    return base, regions, jitter_trace(base, n_rounds, np.random.default_rng(seed))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--txns", type=int, default=12, help="transactions a node an epoch")
    ap.add_argument("--keys", type=int, default=10_000)
    ap.add_argument("--planner", default="milp")
    args = ap.parse_args(argv)
    n, epochs = 5, args.epochs
    base, regions, trace = paper_testbed(epochs)
    print("testbed: Kalgan x2, Hohhot x2, Hong Kong x1 (paper Sec 6.1)")

    def cluster(geococo: bool, seed: int = 5) -> GeoCluster:
        return GeoCluster(
            EngineConfig(n_nodes=n, grouping=geococo, filtering=geococo, tiv=geococo,
                         planner=args.planner),
            bandwidth_mbps=120.0, seed=seed, device=args.device,
        )

    print("\n== TPC-C (100 warehouses) ==")
    tpcc = {}
    for mix in TPCC_MIXES:
        rows = {}
        for name, geococo in (("GeoGauss", False), ("+GeoCoCo", True)):
            gen = TPCCGenerator(TPCCConfig(n_warehouses=100, mix=mix), n, seed=3)
            rows[name] = cluster(geococo, seed=3).run(gen, trace, txns_per_node=args.txns)
        a, b = rows["GeoGauss"], rows["+GeoCoCo"]
        print(f"  {mix}: tpmTotal {a.throughput_tps*60:,.0f} -> {b.throughput_tps*60:,.0f}"
              f"  ({b.throughput_tps/a.throughput_tps-1:+.1%}); "
              f"state identical: {a.state_digest == b.state_digest}")
        tpcc[mix] = rows

    def generator() -> YCSBGenerator:
        return YCSBGenerator(
            YCSBConfig(n_keys=args.keys, theta=0.8, read_ratio=0.5,
                       hot_write_frac=0.3, hot_locality=True),
            n, seed=5, node_region=regions,
        )

    print("\n== YCSB (theta=0.8, 50/50) ==")
    runs = {}
    for name, geococo in (("GeoGauss", False), ("+GeoCoCo", True)):
        runs[name] = cluster(geococo).run(generator(), trace, txns_per_node=args.txns)
    a, b = runs["GeoGauss"], runs["+GeoCoCo"]
    print(f"  txn/s {a.throughput_tps:,.0f} -> {b.throughput_tps:,.0f} "
          f"({b.throughput_tps / a.throughput_tps - 1:+.1%}); WAN bytes {a.wan_bytes:,.0f} -> "
          f"{b.wan_bytes:,.0f}; state identical: {a.state_digest == b.state_digest}")

    print("\n== with aggregator failover ==")
    eng, gen = cluster(True), generator()
    # run half, fail the current aggregator of group 0, run the rest; the
    # failure flows through the control plane as a typed PlanChanged event
    half = epochs // 2
    rs1 = eng.run(gen, trace, txns_per_node=args.txns, n_epochs=half)
    victim = eng.control.plan.aggregators[0]
    eng.control.on_node_failure(victim)
    print(f"  injected failure of aggregator node {victim} at epoch {half}; "
          "members fall back + replan next round")
    rs2 = eng.run(gen, trace, txns_per_node=args.txns, n_epochs=half)
    print(f"  committed {rs1.committed}+{rs2.committed} txns; "
          f"white-data filtered {rs2.white_stats.white_byte_ratio:.0%} of bytes; "
          f"replans: {eng.control.replan_count}; "
          f"control events: {eng.control.event_counts()}")
    print(f"  run completed on {eng.device} with consistent state "
          f"(digest {eng.store.digest()[:12]}..., {eng.store.merges} merges)")
    return {"tpcc": tpcc, "ycsb": runs, "failover": (rs1, rs2), "engine": eng}


if __name__ == "__main__":
    main()
