"""Experiment master: the command-line entry point of the port.

Counterpart of the JAX package's ``master.py``: it loads a YAML experiment,
runs it (``core/config.py:run_experiment``) and exports the recorded
signals as the reference's master does: ``signals/*.tsv``, ``signals.yaml``
and ``config.json`` under ``--out``.

Usage:
    python -m control_box_rst_tpu_torch.master --config experiment.yaml \\
        [--out results_dir] [--format tsv|yaml|both] [--print-signals] \\
        [--device cuda|cpu]
    python -m control_box_rst_tpu_torch.master --serve localhost:50051 \\
        [--config experiment.yaml] [--device cuda|cpu]   # gRPC server mode

``--device`` defaults to the card and raises when there is none; the CPU
has to be asked for. ``--serve ADDR`` runs the gRPC master service
(``comm/server.py``) on ADDR, ``--config`` preloading the experiment; its
first line of output names the address it listens on, with the port it
bound (``localhost:0`` picks a free one).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="control_box_rst_tpu_torch experiment master")
    p.add_argument("--config", "-m", default=None, help="YAML experiment config")
    p.add_argument(
        "--serve", "-s", nargs="?", const="localhost:50051", default=None,
        metavar="ADDR",
        help="run as a gRPC master service on ADDR; --config preloads the experiment",
    )
    p.add_argument("--out", "-o", default=None, help="output directory")
    p.add_argument("--format", choices=("tsv", "yaml", "both"), default="tsv")
    p.add_argument("--print-signals", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card; cpu must be asked for)")
    args = p.parse_args(argv)

    from control_box_rst_tpu_torch.core.config import load_config, run_experiment
    from control_box_rst_tpu_torch.core.export import export_tsv, export_yaml
    from control_box_rst_tpu_torch.utils.precision import resolve_device

    device = resolve_device(args.device)
    if args.serve is not None:
        from concurrent import futures

        import grpc

        from control_box_rst_tpu_torch.comm.server import MasterServer, bound_address

        master = MasterServer(device=device)
        if args.config:
            with open(args.config) as f:
                master.set_section("config", f.read())
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        server.add_generic_rpc_handlers((master.grpc_handler(),))
        port = server.add_insecure_port(args.serve)
        server.start()
        print(f"corbo_tpu master listening on {bound_address(args.serve, port)}", flush=True)
        server.wait_for_termination()
        return 0

    if not args.config:
        p.error("--config is required unless --serve is given")
    config = load_config(args.config)
    t0 = time.perf_counter()
    rec = run_experiment(config, device=device)
    wall = time.perf_counter() - t0
    print(f"experiment finished in {wall:.2f}s on {device}; signals: {sorted(rec.names())}")

    if args.print_signals:
        import numpy as np

        for name in sorted(rec.names()):
            sig = rec.get(name)
            vals = np.asarray(sig.get("values", sig.get("matrices", [])))
            print(f"  {name}: kind={sig['kind']} shape={vals.shape}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        if args.format in ("tsv", "both"):
            export_tsv(rec, os.path.join(args.out, "signals"))
        if args.format in ("yaml", "both"):
            export_yaml(rec, os.path.join(args.out, "signals.yaml"))
        with open(os.path.join(args.out, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
        print(f"results written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
