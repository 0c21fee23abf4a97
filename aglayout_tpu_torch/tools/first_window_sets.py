"""The trees and the runs of `tools/first_window_rule`'s sets.

    python -m aglayout_tpu_torch.tools.first_window_sets prepare
    python -m aglayout_tpu_torch.tools.first_window_sets run A0 A1 ...

`prepare` (where the repo's git history is) writes one tree a set under
`ROOT`: the package of the set's commit (`git archive`), with the set's
files of the package taken from `first_window_rule.CHANGE`, and a
TREE.json naming both and the SHA-256 of the five files the rule splits.
Sets that differ only in their seeds share a tree (A0 and A0+, B2 and
B2+); a set of no commit runs on this checkout. `run` (on the card) runs
each named set's `tools/first_window` at 64^2, B=8, deterministic, TF32
off, from its tree in a process of its own, writing the set's file and
log into `OUT`, and appends the set's tree, the SHA-256 of its five
files, seconds and exit code to `OUT`/runs.json; it goes on past a set
that fails and exits 1 after the last. The study is done and its files
are committed (`first_window_rule.DIR`); this repeats it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

from aglayout_tpu_torch.tools.first_window_rule import ADAM, CHANGE, KEEP_BITS, POOL, SETS
from aglayout_tpu_torch.tools.train_evidence import REPO

PACKAGE = "aglayout_tpu_torch"
ROOT = os.path.join(REPO, "build", "first_window_trees")
OUT = os.path.join(REPO, "chiprun_out", "first_window_64")


def tree_name(name: str) -> str:
    """The tree a set runs on: A0+ runs on A0's, A1+ on A1's."""
    return name.rstrip("+")


def tree_path(name: str) -> str:
    """Where set `name` runs: its tree under `ROOT`, or this checkout."""
    return REPO if SETS[name][1] is None else os.path.join(ROOT, tree_name(name))


def step_files(tree: str) -> dict:
    """The SHA-256 of the five files the rule splits, in `tree`'s package."""
    return {f: _sha256(os.path.join(tree, PACKAGE, f)) for f in KEEP_BITS + ADAM + POOL}


def _git(*args) -> bytes:
    return subprocess.run(["git", "-C", REPO, *args], capture_output=True, check=True).stdout


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def prepare() -> dict:
    """Every set's tree under `ROOT`; returns {tree: its TREE.json}."""
    trees = {}
    for name, (_, commit, files, _) in SETS.items():
        tree = tree_name(name)
        if tree in trees or commit is None:
            continue
        path = os.path.join(ROOT, tree)
        os.makedirs(path, exist_ok=False)
        subprocess.run(["tar", "-x", "-C", path], input=_git("archive", commit, PACKAGE),
                       check=True)
        for f in files:
            with open(os.path.join(path, PACKAGE, f), "wb") as out:
                out.write(_git("show", f"{CHANGE}:{PACKAGE}/{f}"))
        trees[tree] = {"commit": commit, "from_change": {"commit": CHANGE, "files": list(files)},
                       "sha256": step_files(path)}
        with open(os.path.join(path, "TREE.json"), "w") as f:
            json.dump(trees[tree], f, indent=2)
    return trees


def run(names, out: str = OUT):
    """Each set of `names`, in order; returns the runs' records."""
    os.makedirs(out, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    records = []
    for name in names:
        file, _, _, seeds = SETS[name]
        tree = tree_path(name)
        cmd = [sys.executable, "-m", f"{PACKAGE}.tools.first_window", "--image_size", "64",
               "--batch_size", "8", "--deterministic", "--out", os.path.join(out, file),
               "--seeds", *map(str, seeds)]
        t0 = time.time()
        with open(os.path.join(out, file.replace(".json", ".log")), "w") as log:
            rc = subprocess.run(cmd, cwd=tree, env=env, stdout=log,
                                stderr=subprocess.STDOUT).returncode
        records.append({"set": name, "tree": tree_name(name) if SETS[name][1] else "checkout",
                        "sha256": step_files(tree), "seconds": time.time() - t0, "rc": rc,
                        "command": " ".join(cmd[1:]).replace(REPO + os.sep, "")})
        print(json.dumps(records[-1]), flush=True)
        runs = os.path.join(out, "runs.json")
        prior = []
        if os.path.exists(runs):
            with open(runs) as f:
                prior = json.load(f)
        with open(runs, "w") as f:
            json.dump(prior + [records[-1]], f, indent=2)
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=["prepare", "run"])
    p.add_argument("sets", nargs="*", help=f"for run: of {', '.join(SETS)}")
    args = p.parse_args(argv)
    unknown = set(args.sets) - set(SETS)
    if unknown or (args.what == "run") != bool(args.sets):
        p.error(f"run takes sets of {list(SETS)}, prepare none (got {args.sets})")
    if args.what == "prepare":
        print(json.dumps(prepare(), indent=2))
        return
    if any(r["rc"] for r in run(args.sets)):
        sys.exit(1)


if __name__ == "__main__":
    main()
