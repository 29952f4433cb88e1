"""Sidecar entrypoint: ``python -m polyaxon_tpu_torch.sidecar``.

The watcher-uploader auxiliary (SURVEY.md 2.10/5.5, plane (a)/(b)): tails
the run's local outputs/events directories and syncs them to the
artifacts store mount at an interval, with a final sync on shutdown.
In-cluster the store mount is a connection volume; locally the runner
points it at the run store's artifacts root.

The port's own copy of ``polyaxon_tpu/sidecar.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import sys
import time
from typing import Optional


def _sync_tree(src: str, dst: str) -> int:
    """Copy changed files src -> dst; returns files copied."""
    if not os.path.isdir(src):
        return 0
    copied = 0
    for root, _, files in os.walk(src):
        rel = os.path.relpath(root, src)
        target_dir = os.path.join(dst, rel) if rel != "." else dst
        os.makedirs(target_dir, exist_ok=True)
        for name in files:
            s = os.path.join(root, name)
            d = os.path.join(target_dir, name)
            try:
                if (not os.path.exists(d)
                        or os.path.getmtime(s) > os.path.getmtime(d)
                        or os.path.getsize(s) != os.path.getsize(d)):
                    shutil.copy2(s, d)
                    copied += 1
            except OSError:
                continue  # file mid-write; next tick gets it
    return copied


class Sidecar:
    def __init__(self, run_uuid: str, local_root: str, store_root: str,
                 sync_interval: int = 10, collect_logs: bool = True,
                 collect_artifacts: bool = True):
        self.run_uuid = run_uuid
        self.local_root = local_root
        self.store_root = store_root
        self.sync_interval = max(1, sync_interval)
        self.collect_logs = collect_logs
        self.collect_artifacts = collect_artifacts
        self._stop = False

    def sync_once(self) -> int:
        copied = 0
        dst = os.path.join(self.store_root, self.run_uuid)
        if self.collect_artifacts:
            # Store layout (client.store): events/, artifacts/ (outputs
            # inside); plus bare outputs/assets for unmanaged local dirs.
            for sub in ("artifacts", "events", "outputs", "assets"):
                copied += _sync_tree(os.path.join(self.local_root, sub),
                                     os.path.join(dst, sub))
        if self.collect_logs:
            copied += _sync_tree(os.path.join(self.local_root, "logs"),
                                 os.path.join(dst, "logs"))
        return copied

    def run(self, max_ticks: Optional[int] = None) -> None:
        def stop(signum, frame):
            self._stop = True

        signal.signal(signal.SIGTERM, stop)
        signal.signal(signal.SIGINT, stop)
        ticks = 0
        while not self._stop:
            self.sync_once()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
            deadline = time.time() + self.sync_interval
            while time.time() < deadline and not self._stop:
                time.sleep(0.2)
        self.sync_once()  # final sync


def main(argv=None) -> int:
    from .k8s.auxiliaries import ARTIFACTS_MOUNT

    parser = argparse.ArgumentParser(prog="polyaxon_tpu_torch.sidecar")
    parser.add_argument("--run-uuid", required=True)
    parser.add_argument("--local-root", default=None,
                        help="run's local working dir (default: cwd/.ptpu)")
    parser.add_argument("--store-root", default=None)
    parser.add_argument("--sync-interval", type=int, default=10)
    parser.add_argument("--collect-logs", default="true")
    parser.add_argument("--collect-artifacts", default="true")
    parser.add_argument("--max-ticks", type=int, default=None)
    args = parser.parse_args(argv)

    local_root = args.local_root or os.path.join(os.getcwd(), ".ptpu",
                                                 args.run_uuid)
    store_root = args.store_root or os.environ.get(
        "POLYAXON_TPU_ARTIFACTS_PATH", ARTIFACTS_MOUNT)
    # The env var points at the run's dir; the sidecar writes runs under
    # the store root, so strip a trailing run-uuid path segment.
    if os.path.basename(store_root.rstrip("/")) == args.run_uuid:
        store_root = os.path.dirname(store_root.rstrip("/"))

    Sidecar(
        run_uuid=args.run_uuid,
        local_root=local_root,
        store_root=store_root,
        sync_interval=args.sync_interval,
        collect_logs=args.collect_logs != "false",
        collect_artifacts=args.collect_artifacts != "false",
    ).run(max_ticks=args.max_ticks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
