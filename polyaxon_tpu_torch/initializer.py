"""Init-container entrypoint: ``python -m polyaxon_tpu_torch.initializer <action>``.

Implements the init actions the converter schedules (SURVEY.md 2.10 —
reference init containers for git clone / artifact pull / dockerfile gen /
inline files, expected at ``polyaxon/_k8s/converter`` auxiliaries,
unverified).  Runs standalone inside the aux container; also callable
in-process by the local runner so ``init:`` sections work without k8s.

The port's own copy of ``polyaxon_tpu/initializer.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from typing import List, Optional


class InitError(RuntimeError):
    pass


def init_git(url: str, dest: str, revision: Optional[str] = None,
             flags: Optional[List[str]] = None) -> str:
    if not url:
        raise InitError("git init requires a url")
    os.makedirs(dest, exist_ok=True)
    repo_dir = os.path.join(dest, os.path.basename(url).removesuffix(".git")
                            or "repo")
    cmd = ["git", "clone", *(flags or []), url, repo_dir]
    subprocess.run(cmd, check=True)
    if revision:
        subprocess.run(["git", "-C", repo_dir, "checkout", revision],
                       check=True)
    return repo_dir


def resolve_connection_root(connection: str) -> str:
    """Filesystem root of a named connection.

    Connection catalogs mount/export each connection's root as
    ``POLYAXON_TPU_CONNECTION_<NAME>_ROOT`` (the converter's connection
    volumes and the local runner both set this).  A connection that is
    not materialized is an explicit error — never a silent no-op.
    """
    key = ("POLYAXON_TPU_CONNECTION_"
           + connection.upper().replace("-", "_") + "_ROOT")
    root = os.environ.get(key)
    if not root:
        raise InitError(
            f"Connection {connection!r} is not materialized in this "
            f"container (env {key} unset)")
    return root


def init_artifacts(dest: str, files: List[str], dirs: List[str],
                   connection: Optional[str] = None,
                   store_root: Optional[str] = None,
                   sub_targets: bool = False) -> List[str]:
    """Copy artifacts from the (mounted) store into the context dir.

    ``store_root`` defaults to the in-pod artifacts mount; the local
    runner passes the run store's artifacts root instead.  With a
    ``connection``, paths resolve against that connection's root, and a
    bare connection (no files/dirs) copies the whole root.
    ``sub_targets`` keeps each dir's relative path under ``dest``
    (instead of its basename) so multiple sources can't collide.
    """
    from .k8s.auxiliaries import ARTIFACTS_MOUNT

    if connection:
        root = resolve_connection_root(connection)
        if not files and not dirs:
            dirs = ["."]
    else:
        root = store_root or os.environ.get("POLYAXON_TPU_ARTIFACTS_PATH",
                                            ARTIFACTS_MOUNT)
    os.makedirs(dest, exist_ok=True)
    copied = []
    for rel in files:
        src = rel if os.path.isabs(rel) else os.path.join(root, rel)
        target = os.path.join(dest, rel if sub_targets
                              else os.path.basename(rel))
        os.makedirs(os.path.dirname(target), exist_ok=True)
        shutil.copy2(src, target)
        copied.append(target)
    for rel in dirs:
        src = rel if os.path.isabs(rel) else os.path.join(root, rel)
        if rel == ".":
            target = dest
        else:
            target = os.path.join(dest, rel.rstrip("/") if sub_targets
                                  else os.path.basename(rel.rstrip("/")))
        shutil.copytree(src, target, dirs_exist_ok=True)
        copied.append(target)
    return copied


def init_file(dest: str, filename: str, content: str,
              chmod: Optional[str] = None) -> str:
    os.makedirs(dest, exist_ok=True)
    path = os.path.join(dest, filename)
    with open(path, "w") as f:
        f.write(content)
    if chmod:
        os.chmod(path, int(chmod, 8))
    return path


def init_dockerfile(dest: str, spec: dict) -> str:
    """Render a Dockerfile from a V1DockerfileInit spec."""
    lines = [f"FROM {spec.get('image', 'python:3.11-slim')}"]
    for k, v in (spec.get("env") or {}).items():
        lines.append(f"ENV {k}={v}")
    if spec.get("workdir"):
        lines.append(f"WORKDIR {spec['workdir']}")
    for entry in spec.get("copy") or spec.get("copy_") or []:
        if isinstance(entry, (list, tuple)):
            lines.append(f"COPY {entry[0]} {entry[1]}")
        else:
            lines.append(f"COPY {entry} .")
    for cmd in spec.get("run") or []:
        lines.append(f"RUN {cmd}")
    return init_file(dest, spec.get("filename") or "Dockerfile",
                     "\n".join(lines) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="polyaxon_tpu_torch.initializer")
    sub = parser.add_subparsers(dest="action", required=True)

    p = sub.add_parser("git")
    p.add_argument("--url", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--revision")
    p.add_argument("--flag", action="append", dest="flags", default=[])

    p = sub.add_parser("artifacts")
    p.add_argument("--dest", required=True)
    p.add_argument("--file", action="append", dest="files", default=[])
    p.add_argument("--dir", action="append", dest="dirs", default=[])
    p.add_argument("--connection")
    p.add_argument("--store-root")

    p = sub.add_parser("file")
    p.add_argument("--dest", required=True)
    p.add_argument("--filename", required=True)
    p.add_argument("--content", required=True)
    p.add_argument("--chmod")

    p = sub.add_parser("dockerfile")
    p.add_argument("--dest", required=True)
    p.add_argument("--spec", required=True)

    p = sub.add_parser("tensorboard")
    p.add_argument("--dest", required=True)
    p.add_argument("--spec", required=True)

    args = parser.parse_args(argv)
    if args.action == "git":
        init_git(args.url, args.dest, args.revision, args.flags)
    elif args.action == "artifacts":
        init_artifacts(args.dest, args.files, args.dirs,
                       connection=args.connection,
                       store_root=args.store_root)
    elif args.action == "file":
        init_file(args.dest, args.filename, args.content, args.chmod)
    elif args.action == "dockerfile":
        init_dockerfile(args.dest, json.loads(args.spec))
    elif args.action == "tensorboard":
        # Event files live in run artifact dirs; pull each referenced
        # run's events under its own subdir so TensorBoard shows them as
        # separate comparable runs.
        spec = json.loads(args.spec)
        init_artifacts(args.dest, [], [f"{u}/events"
                                       for u in spec.get("uuids") or []],
                       sub_targets=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
