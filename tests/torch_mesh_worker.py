"""One rank of a spawned world running the port's placements (a helper of
tests/test_torch_execution.py; it imports neither jax nor repro).

    python tests/torch_mesh_worker.py CASES.json OUT.json RANK

``CASES.json`` holds the world size, the rendezvous file, the graph's
arrays and the cases; every rank runs them all in the same order (the
placements' collectives pair up across ranks) and writes what it saw to
``OUT.json``: labels, stats, the sampler's labels ``P0``, stream answers,
SCAN labels and cores.
"""

import dataclasses
import json
import sys

import numpy as np
import torch

STATS = ("variant", "exec", "placement", "devices", "edges_total",
         "edges_finish", "edges_finish_padded", "edges_per_device",
         "dispatch_sizes", "batch_shapes", "lmax_count", "finish_rounds",
         "fused")


def _stats(st) -> dict:
    d = dataclasses.asdict(st)
    return {k: list(d[k]) if isinstance(d[k], tuple) else d[k]
            for k in STATS}


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.int32))


def run_connectivity(tapi, g, case: dict) -> dict:
    ci = tapi.ConnectIt(case["variant"], exec=case["exec"], device="cpu")
    seen = []
    if ci._sampler is not None:
        sampler = ci._sampler
        if case.get("replay") is not None:
            P = _tensor(case["replay"])

            def sampler(g, gen):  # noqa: F811 - the reference's P0, replayed
                return P.clone()

        def recording(g, gen, _inner=sampler):
            P0 = _inner(g, gen)
            seen.append(P0.tolist())
            return P0

        ci._sampler = recording
    labels, stats = ci.connectivity(g, return_stats=True)
    return {"labels": labels.tolist(), "stats": _stats(stats),
            "P0": seen[0] if seen else None}


def run_stream(tapi, n: int, case: dict) -> dict:
    st = tapi.ConnectIt(case["variant"], exec=case["exec"],
                        device="cpu").stream(n)
    answers = [st.process(u, v, qa, qb).tolist()
               for u, v, qa, qb in case["batches"]]
    return {"answers": answers, "labels": st.labels.tolist(),
            "ncomp": st.num_components(), "stats": _stats(st.stats)}


def run_scan(tapi, g, case: dict) -> dict:
    ci = tapi.ConnectIt(case["variant"], exec=case["exec"], device="cpu")
    labels, cores, stats = ci.scan(
        g, torch.tensor(np.asarray(case["sims"], np.float32)), case["spec"],
        return_stats=True)
    return {"labels": labels.tolist(), "cores": cores.tolist(),
            "stats": _stats(stats)}


def main(cases_path: str, out_path: str, rank: int) -> int:
    torch.set_num_threads(1)
    from repro_torch import api as tapi
    from repro_torch.graphs import graph_from_arrays
    from repro_torch.launch import multihost

    with open(cases_path) as f:
        cases = json.load(f)
    gd = cases["graph"]
    g = graph_from_arrays(*(np.asarray(gd[k], np.int32) for k in
                            ("senders", "receivers", "indptr", "indices")),
                          gd["n"], gd["m"], device="cpu")
    multihost.initialize(init_method=f"file://{cases['store']}",
                         num_processes=cases["world"], process_id=rank,
                         backend="gloo", timeout=120)
    try:
        out = {"connectivity": [run_connectivity(tapi, g, c)
                                for c in cases["connectivity"]],
               "stream": [run_stream(tapi, g.n, c)
                          for c in cases["stream"]],
               "scan": [run_scan(tapi, g, c) for c in cases["scan"]]}
    finally:
        multihost.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
