"""GeoCoCo quickstart on the PyTorch port: the paper's pipeline end to end,
the replicated store on the card.

    PYTHONPATH=src python examples/quickstart_torch.py              # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. Build a geo-clustered WAN and monitor it.
2. Plan latency-aware groups (MILP) with TIV-aware relays.
3. Synchronize one round flat and hierarchically on the WAN simulator.
4. Run 30 epochs of YCSB, flat against GeoCoCo (grouping, white-data
   filtering): throughput, WAN bytes and one final state.

The store, validation, the filter and the commit run on ``--device``; the
planner, the schedules and the WAN simulator on the host.
"""

import argparse

import numpy as np

from repro_torch.core.latency import GeoClusterSpec, geo_clustered_matrix, jitter_trace, tiv_fraction
from repro_torch.core.planner import best_plan
from repro_torch.core.replication import EngineConfig, GeoCluster
from repro_torch.core.schedule import all_to_all_schedule, hierarchical_schedule
from repro_torch.core.simulator import WANSimulator
from repro_torch.core.workload import YCSBConfig, YCSBGenerator


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    n = 9
    lat, regions = geo_clustered_matrix(
        GeoClusterSpec(n_nodes=n, n_clusters=3, congestion_frac=0.35), rng
    )
    print(f"{n}-node WAN over 3 regions; "
          f"{tiv_fraction(lat):.0%} of pairs violate the triangle inequality")

    # LAN >> WAN bandwidth asymmetry (paper Sec 2.2)
    same = regions[:, None] == regions[None, :]
    bw = np.where(same, 10_000.0, 150.0).astype(float)
    np.fill_diagonal(bw, np.inf)

    # --- Planner: latency-aware grouping (paper Sec 4.2) -------------------
    plan = best_plan(lat, tiv=True, method="milp",
                     payload_bytes=100_000.0, bandwidth_mbps=bw)
    print(f"plan: k={plan.k} groups {plan.groups} aggregators {plan.aggregators}"
          f"  (objective {plan.objective:.1f} ms, solved in {plan.solve_time_s*1e3:.0f} ms)")

    # --- Communicator: one round, flat vs hierarchical ---------------------
    sim = WANSimulator(lat, bandwidth_mbps=bw)
    m_flat = sim.run(all_to_all_schedule(n, 100_000.0)).makespan_ms
    m_geo = sim.run(
        hierarchical_schedule(plan, 100_000.0, lat=lat, tiv=True)
    ).makespan_ms
    print(f"single-round makespan: flat {m_flat:.0f} ms -> geococo {m_geo:.0f} ms"
          f"  ({1 - m_geo / m_flat:+.0%})")

    # --- Full engine: epochs with OCC + CRDT + filtering, the store on the device
    trace = jitter_trace(lat, 30, np.random.default_rng(1))
    results = {}
    for name, (grp, filt) in {"flat": (False, False),
                              "geococo": (True, True)}.items():
        eng = GeoCluster(
            EngineConfig(n_nodes=n, grouping=grp, filtering=filt, tiv=True,
                         planner="kcenter"),
            bandwidth_mbps=bw, wan_mask=~same, seed=2, device=args.device,
        )
        gen = YCSBGenerator(
            YCSBConfig(n_keys=5000, theta=0.8, read_ratio=0.5,
                       hot_write_frac=0.3, hot_locality=True),
            n, seed=3, node_region=regions,
        )
        results[name] = eng.run(gen, trace, txns_per_node=10)

    a, b = results["flat"], results["geococo"]
    print(f"30 epochs: throughput {a.throughput_tps:.0f} -> {b.throughput_tps:.0f} tps"
          f" ({b.throughput_tps / a.throughput_tps - 1:+.0%}),"
          f" WAN bytes {a.wan_bytes/1e6:.1f} -> {b.wan_bytes/1e6:.1f} MB"
          f" ({1 - b.wan_bytes / a.wan_bytes:+.0%} saved),"
          f" white-data ratio {b.white_stats.white_byte_ratio:.0%}")
    if a.state_digest != b.state_digest:
        raise SystemExit("flat and geococo ended in different states")
    print(f"final replicated state identical across modes on {eng.device} — "
          "filtering is lossless")
    return {"plan": plan, "makespans_ms": (m_flat, m_geo), "runs": results}


if __name__ == "__main__":
    main()
