"""Manually (re-)register a worker with the controller (the port's own
copy of ``matryoshka_mm_tpu/serve/register_worker.py``).

Covers the reference capability (llava/serve/register_worker.py): point the
controller at a worker that was started with ``--no-register`` or that the
controller has forgotten.  When the worker is reachable, its live status is
fetched and forwarded so the controller starts with real queue/model info
instead of a blank entry.
"""

from __future__ import annotations

import argparse
import sys


def register(controller_address: str, worker_name: str,
             check_heart_beat: bool = False, fetch_status: bool = True) -> dict:
    import requests

    status = None
    if fetch_status:
        try:
            status = requests.post(worker_name + "/worker_get_status",
                                   timeout=5).json()
        except requests.RequestException:
            status = None     # controller will poll the worker itself
    r = requests.post(controller_address + "/register_worker", json={
        "worker_name": worker_name,
        "check_heart_beat": check_heart_beat,
        "worker_status": status,
    })
    r.raise_for_status()
    return {"worker": worker_name, "status_forwarded": status is not None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--controller-address", type=str, required=True)
    ap.add_argument("--worker-name", type=str, required=True,
                    help="worker base URL, e.g. http://host:21002")
    ap.add_argument("--check-heart-beat", action="store_true")
    ap.add_argument("--no-fetch-status", action="store_true",
                    help="register without querying the worker first")
    args = ap.parse_args(argv)
    out = register(args.controller_address, args.worker_name,
                   args.check_heart_beat, not args.no_fetch_status)
    print(f"registered {out['worker']} "
          f"(status {'forwarded' if out['status_forwarded'] else 'omitted'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
