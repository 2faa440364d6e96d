"""Two-level cluster scheduling demo on the PyTorch port: node-level DLS
over replicas (``examples/cluster_demo.py`` on ``repro_torch``).

Shows the cross-node layer (repro_torch.serve.cluster) end to end:

  1. node-technique sweep on skewed traffic -- dynamic node scheduling
     vs static replica partitioning, with the paper's Table-1 imbalance
     metrics aggregated over per-replica busy time;
  2. a degraded replica, served wave by wave with a persistent
     ClusterRouter -- the AWF node weights converge toward the replica
     speed ratio, so the slow node is handed proportionally less work.

The cluster layer is host code (NumPy), so ``--device`` changes nothing
here; it is taken for symmetry with the other examples.

    PYTHONPATH=src python examples/torch_cluster_demo.py
"""

import argparse

import numpy as np

from repro_torch.core.metrics import LoopRecorder
from repro_torch.serve.cluster import (
    ClusterRouter,
    make_traffic,
    simulate_cluster,
)

REPLICAS, WORKERS = 8, 4
NODES = ("static", "ss,4", "gss", "fac2", "awf_b")


def run():
    """The sweep's results by node technique, the recorder, and the
    degraded-replica waves' results."""
    reqs = make_traffic("spiky", n=800, seed=1)
    recorder = LoopRecorder()
    results = {}
    for node in NODES:
        results[node] = simulate_cluster(
            reqs, num_replicas=REPLICAS, workers_per_replica=WORKERS,
            schedule=f"{node}/fac2", recorder=recorder)
    speed = np.ones(4)
    speed[0] = 2.0  # replica 0 runs at half throughput
    router = ClusterRouter(4, schedule="awf_c")
    waves = [simulate_cluster(make_traffic("uniform", n=200, seed=10 + wave),
                              num_replicas=4, workers_per_replica=WORKERS,
                              schedule="awf_c/fac2", replica_speed=speed,
                              router=router)
             for wave in range(5)]
    return results, recorder, waves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.parse_args(argv)
    results, recorder, waves = run()

    print(f"spiky traffic, {REPLICAS} replicas x {WORKERS} slots "
          f"(intra-node fac2):")
    for node, r in results.items():
        print(f"  {node:7s} makespan={r['makespan']:7.3f}s "
              f"p99={r['p99']:7.3f}s cross-node c.o.v.="
              f"{r['cross_node_cov']:.3f} p.i.={r['cross_node_pi']:5.1f}% "
              f"node_chunks={r['node_chunks']}")
    static = results["static"]["makespan"]
    dynamic = {k: v for k, v in results.items() if k != "static"}
    best = min(dynamic, key=lambda k: dynamic[k]["makespan"])
    print(f"  -> best dynamic ({best}) beats static replica partitioning "
          f"{static / dynamic[best]['makespan']:.2f}x")
    assert recorder.records, "cluster runs should land in the LoopRecorder"

    print("\ndegraded replica (2x slower), awf_c node weights per wave:")
    for wave, r in enumerate(waves):
        w = r["node_weights"]
        print(f"  wave {wave}: weights="
              f"[{', '.join(f'{x:.3f}' for x in w)}] "
              f"requests={r['replica_requests']}")
    assert w[0] == min(w), "slow replica should get the smallest weight"
    print("  -> replica 0 share converged near the 1/2 speed ratio "
          f"({w[0] / (sum(w) / 4):.2f}x of mean)")


if __name__ == "__main__":
    main()
