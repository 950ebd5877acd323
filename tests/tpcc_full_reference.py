"""The reference's ``GeoCluster`` on the CPU at ``chip_smoke.py``'s phase 33
(b) settings: TPCC_WAREHOUSES x TPCC_ITEMS, TPCC-A, remote 0.10, 5 nodes
on the paper's testbed at WAN_BANDWIDTH_MBPS, kcenter, no WAN mask,
TPCC_TXNS transactions a node an epoch for TPCC_EPOCHS epochs, flat then
geococo, with the same seeds.  The store starts empty (the reference's
store is a dict of the keys written) and the filter's CPU time is
modeled from its bytes, as in phase 33 (d) on the card, whose line this
script prints in the same form: the two can be compared number for number
and digest for digest.

    PYTHONPATH=src python tests/tpcc_full_reference.py [--txns N]

Not a test: pytest does not collect it.  The reference's WAN plane is
numpy only; this imports no JAX.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from repro.core import EngineConfig, GeoCluster, TPCCConfig, TPCCGenerator, jitter_trace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402  (its settings and line; no torch at load)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--txns", type=int, default=smoke.TPCC_TXNS,
                    help="transactions a node an epoch")
    args = ap.parse_args(argv)
    n = len(smoke.WAN_REGIONS)
    out = {}
    for strategy in ("flat", "geococo"):
        t0 = time.perf_counter()
        eng = GeoCluster(EngineConfig(n_nodes=n, sync_strategy=strategy, planner="kcenter",
                                      modeled_cpu=True),
                         bandwidth_mbps=smoke.WAN_BANDWIDTH_MBPS, seed=3)
        gen = TPCCGenerator(TPCCConfig(n_warehouses=smoke.TPCC_WAREHOUSES, mix="TPCC-A",
                                       remote_prob=0.10,
                                       items_per_warehouse=smoke.TPCC_ITEMS), n, seed=3)
        trace = jitter_trace(np.array(smoke.WAN_TESTBED), smoke.TPCC_EPOCHS,
                             np.random.default_rng(0))
        rs = eng.run(gen, trace, txns_per_node=args.txns, n_epochs=smoke.TPCC_EPOCHS)
        print(smoke.tpcc_summary_line(strategy, rs, gen))
        print(f"  {len(eng.store)} keys present; {time.perf_counter() - t0:.1f} s on the CPU",
              flush=True)
        out[strategy] = rs
    return out


if __name__ == "__main__":
    main()
