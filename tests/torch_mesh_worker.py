"""One rank of a spawned world running the port's placements (a helper of
tests/test_torch_execution.py; it imports neither jax nor repro).

    python tests/torch_mesh_worker.py CASES.json OUT.json RANK

``CASES.json`` holds the world size, the rendezvous file, the graph's
arrays and the cases; every rank runs them all in the same order (the
placements' collectives pair up across ranks) and writes what it saw to
``OUT.json``: labels, stats, the sampler's labels ``P0``, stream answers,
SCAN labels and cores, dynamic streams (answers, labels, forest, this
rank's log block), AMSF forests, the served runs (rank 0 serves, the
other ranks follow) and ``ConnectIt("auto")`` sessions, each rank on the
tuning cache its environment names. A section missing from the cases is
skipped.
"""

import asyncio
import dataclasses
import json
import os
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


def run_dynamic(tapi, n: int, case: dict) -> dict:
    st = tapi.ConnectIt(case["variant"], exec=case["exec"],
                        device="cpu").stream(n)
    answers = [st.process(*b).tolist() for b in case["batches"]]
    state = st.state
    return {"answers": answers, "labels": st.labels.tolist(),
            "fu": state.fu.tolist(), "fv": state.fv.tolist(),
            "log_u": state.log_u.tolist(), "log_v": state.log_v.tolist(),
            "used": st.log_used(), "stats": _stats(st.stats)}


def run_amsf(tapi, g, weights, case: dict) -> dict:
    ci = tapi.ConnectIt(case["variant"], exec=case["exec"], device="cpu")
    edges, stats = ci.amsf(g, weights, case["spec"], return_stats=True)
    return {"edges": edges.tolist(), "stats": _stats(stats),
            "buckets": stats.buckets,
            "edges_per_bucket": list(stats.edges_per_bucket)}


def _served(store, n: int) -> dict:
    from repro_torch.core.execution import served_labels
    st = store._committed
    out = {"P": served_labels(st)[: n + 1].tolist(), "epoch": store.epoch,
           "epoch_edges": store.epoch_edges,
           "rounds": store.rounds_total}
    if store.dynamic:
        dyn = getattr(st, "state", st)
        out.update(fu=dyn.fu.tolist(), fv=dyn.fv.tolist())
    return out


def run_serve(tapi, n: int, case: dict) -> dict:
    """Rank 0 serves ``case["ops"]`` one request at a time (each its own
    commit, so the epochs are the ops' order); the others follow."""
    from repro_torch.serve import Follower, ServeConfig
    cfg = ServeConfig(max_batch_edges=256, max_batch_queries=256,
                      flush_ms=0.5, warmup=True)
    server = tapi.ConnectIt(case["variant"], exec=case["exec"],
                            device="cpu").serve(n, config=cfg)
    if isinstance(server, Follower):
        replayed = server.run()
        return {"role": "follower", "replayed": replayed,
                "errors": [repr(e) for e in server.errors],
                **_served(server.store, n)}
    answers = []

    async def main():
        async with server:
            for op, a, b in case["ops"]:
                if op == "ins":
                    await server.submit_inserts(a, b)
                elif op == "del":
                    await server.submit_deletes(a, b)
                else:
                    ans, epoch = await server.query(a, b)
                    answers.append([ans.tolist(), epoch])

    try:
        asyncio.run(main())
    finally:
        server.stop_followers()
    stats = dataclasses.asdict(server.stats())
    stats = {k: list(v) if isinstance(v, tuple) else v
             for k, v in stats.items()}
    return {"role": "leader", "answers": answers, "stats": stats,
            **_served(server.store, n)}


def run_tune(tapi, g, case: dict, rank: int) -> dict:
    """``ConnectIt("auto")`` under ``case["exec"]`` on this rank's cache
    ``case["caches"][rank]``, then under ``exec + ":tune"`` on the fresh
    cache file ``case["fresh"][rank]``. With ``case["ranks"]`` the session
    runs on a mesh over those ranks only, which every rank makes, and the
    other ranks return ``{}``."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import tune
    mesh = None
    if "ranks" in case:
        mesh = DeviceMesh("cpu", case["ranks"], mesh_dim_names=("x",))
        if rank not in case["ranks"]:
            return {}
    os.environ["REPRO_TORCH_TUNE_CACHE"] = case["caches"][rank]
    tune.reset_default_cache()
    ci = tapi.ConnectIt("auto", exec=case["exec"], mesh=mesh, device="cpu")
    labels, stats = ci.connectivity(g, return_stats=True)
    out = {"global": str(ci.spec), "variant": stats.variant,
           "labels": labels.tolist()}
    os.environ["REPRO_TORCH_TUNE_CACHE"] = case["fresh"][rank]
    tune.reset_default_cache()
    ci = tapi.ConnectIt("auto", exec=f"{case['exec']}:tune", mesh=mesh,
                        device="cpu")
    labels, stats = ci.connectivity(g, return_stats=True)
    out.update(tuned=stats.variant, tuned_labels=labels.tolist(),
               tuned_exec=stats.exec)
    return out


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
    weights = torch.tensor(np.asarray(cases.get("weights", ()), np.float32))
    sections = {
        "connectivity": lambda c: run_connectivity(tapi, g, c),
        "stream": lambda c: run_stream(tapi, g.n, c),
        "scan": lambda c: run_scan(tapi, g, c),
        "dynamic": lambda c: run_dynamic(tapi, g.n, c),
        "amsf": lambda c: run_amsf(tapi, g, weights, c),
        "serve": lambda c: run_serve(tapi, g.n, c),
        "tune": lambda c: run_tune(tapi, g, c, rank),
    }
    try:
        out = {name: [run(c) for c in cases[name]]
               for name, run in sections.items() if name in cases}
    finally:
        multihost.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
