"""Build-at-first-use for the port's native libraries.

Both shared libraries of the port (the C++ host planner and the CUDA
kernels) are compiled from the checkout's sources into the gitignored
`occuseg_tpu_torch/build/` directory. The output file name carries a hash
of the sources, headers and flags, so a changed source is rebuilt and a
stale library is never loaded. Every source compiles to its own object in
a separate compiler process, all started together, and the objects are
then linked; the result is renamed into place from a private temporary
directory, so concurrent first uses (pytest workers) never see a
half-written library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "build")


def build_shared_library(name: str, sources: Sequence[str],
                         compiler: Sequence[str], flags: Sequence[str],
                         headers: Sequence[str] = ()) -> str:
    """Compile `sources` (each with `flags`, in parallel) and link them
    with `-shared` into BUILD_DIR/lib<name>-<hash>.so unless that file
    exists; return its path. `headers` only enter the hash. The compilers'
    output is kept beside the library as `<path>.log`. Raises RuntimeError
    with that output when a step fails."""
    h = hashlib.sha256()
    for part in (*compiler, *flags):
        h.update(part.encode())
    for src in (*sources, *headers):
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(sources))]
        cmds = [[*compiler, *flags, "-c", "-o", obj, src]
                for obj, src in zip(objs, sources)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        log, ok = [], True
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            ok = ok and proc.returncode == 0
        so = os.path.join(tmp, "lib.so")
        if ok:
            cmd = [*compiler, *flags, "-shared", "-o", so, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            ok = proc.returncode == 0
        if not ok:
            raise RuntimeError(f"building {name} failed:\n" + "\n".join(log))
        with open(path + ".log", "w") as f:
            f.write("\n".join(log))
        os.replace(so, path)
    return path
