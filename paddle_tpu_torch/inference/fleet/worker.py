"""Replica worker: one serving engine in its own OS process (counterpart
of ``paddle_tpu/inference/fleet/worker.py``).

Launched by :class:`~paddle_tpu_torch.inference.fleet.cluster.
FleetSupervisor` as ``python -m paddle_tpu_torch.inference.fleet.worker
--spec-file <path>``.  The spec is plain JSON (model config, device,
engine kwargs, seed), so the child rebuilds its own weights
deterministically — nothing crosses the process boundary at spawn
except the spec and, later, frames on the RPC socket.  A spec on
``cuda`` with no card in sight raises before the handshake (the worker
never builds on the CPU instead).  The worker loads the kernel libraries
already built under ``build/kernels``; a missing one is built at its
first launch.

Startup handshake: one line on stdout ::

    PTPU_WORKER_READY {"port": ..., "pid": ..., "replica_id": ...,
                       "scrape_port": ...}

then the socket serve loop runs until a ``shutdown`` RPC (or a signal).

Crash forensics (docs/TELEMETRY.md "Flight recorder"): when the spec
carries ``flight_dir``, a FlightRecorder is installed at boot and

- an UNHANDLED exception dumps a ``replica_crash`` bundle (exception,
  traceback, replica id) before the process exits non-zero;
- SIGTERM dumps a ``replica_sigterm`` bundle before exiting —

both are ordinary ``ptpu-flight-1`` bundles that
``tools/flight_report.py`` loads and validates.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import traceback


def _install_crash_paths(replica_id):
    from ...telemetry import flight as _flight

    def _excepthook(exc_type, exc, tb):
        _flight.maybe_dump("replica_crash", {
            "replica_id": replica_id,
            "pid": os.getpid(),
            "exc": repr(exc),
            "traceback": "".join(
                traceback.format_exception(exc_type, exc, tb))[-4000:],
        })
        sys.__excepthook__(exc_type, exc, tb)
        # the frame-pump thread state is unrecoverable; exit loudly
        os._exit(1)

    def _on_sigterm(signum, frame):
        _flight.maybe_dump("replica_sigterm", {
            "replica_id": replica_id,
            "pid": os.getpid(),
            "signal": int(signum),
        })
        os._exit(0)

    sys.excepthook = _excepthook
    signal.signal(signal.SIGTERM, _on_sigterm)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.inference.fleet.worker")
    ap.add_argument("--spec", help="JSON replica spec")
    ap.add_argument("--spec-file", help="path to a JSON replica spec")
    args = ap.parse_args(argv)
    if args.spec_file:
        with open(args.spec_file) as f:
            spec = json.load(f)
    elif args.spec:
        spec = json.loads(args.spec)
    else:
        ap.error("one of --spec / --spec-file is required")

    replica_id = spec.get("replica_id", 0)
    flight_dir = spec.get("flight_dir")
    if flight_dir:
        from ...telemetry import flight as _flight
        _flight.install(flight_dir)
    _install_crash_paths(replica_id)

    from ... import telemetry as _telemetry
    from ...telemetry.scrape import ScrapeServer
    from .cluster import _engine_from_spec, build_model_from_spec
    from .transport import ReplicaServer, SocketServerLoop

    scrape_port = None
    if spec.get("metrics"):
        _telemetry.enable()
        scrape = ScrapeServer(_telemetry.get_registry(),
                              replica_id=replica_id).start()
        scrape_port = scrape.port

    engine = _engine_from_spec(spec, replica_id)

    def model_factory(version=None):
        return build_model_from_spec(spec, version=version)

    server = ReplicaServer(engine, replica_id=replica_id,
                           model_factory=model_factory,
                           scrape_port=scrape_port)
    loop = SocketServerLoop(server, port=spec.get("port", 0))
    print("PTPU_WORKER_READY " + json.dumps({
        "port": loop.port, "pid": os.getpid(),
        "replica_id": replica_id, "scrape_port": scrape_port}),
        flush=True)
    loop.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
