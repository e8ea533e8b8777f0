"""CPU ranks for the port's multi-process tests (tests/test_torch_sp.py,
test_torch_pp.py, test_torch_ep.py): each set of `world` ranks is a set of
Python processes started once for a test module, joined by gloo through a
rendezvous file in a temporary directory, each running the module's
rank_main(rank, world, directory) with one thread, rank 0 saving what it
returns; a hard timeout ends a hung set.  The tests read the results while
the JAX package's side runs in the test process."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv: rank, world, directory, the tests' directory, the module's name
RANK_PROG = textwrap.dedent('''
    import importlib
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[4])
    M = importlib.import_module(sys.argv[5])
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    out = M.rank_main(rank, world, d)
    if rank == 0:
        torch.save(out, d + "/out.pt")
    print("RANK_OK", rank, flush=True)
''')


class Ranks:
    """Sets of ranks of the sizes in `worlds`, all started at once; [world]
    waits for that set (a failed or hung rank fails the test) -> rank 0's
    results."""

    def __init__(self, module: str, worlds, tmp_path_factory, timeout: float):
        self.timeout = timeout
        self.dirs = {w: str(tmp_path_factory.mktemp(f"{module}_world{w}")) for w in worlds}
        self.procs = {w: self._start(module, w, d) for w, d in self.dirs.items()}
        self.done = {}

    @staticmethod
    def _start(module, world, d):
        prog = os.path.join(d, "rank.py")
        with open(prog, "w") as f:
            f.write(RANK_PROG)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        here = os.path.dirname(os.path.abspath(__file__))
        return [subprocess.Popen([sys.executable, prog, str(r), str(world), d, here, module],
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
                for r in range(world)]

    def __getitem__(self, world):
        if world not in self.done:
            procs, outs = self.procs[world], []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=self.timeout)[0])
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"a rank ran past {self.timeout} s")
            for r, (p, o) in enumerate(zip(procs, outs)):
                assert p.returncode == 0 and f"RANK_OK {r}" in o, f"rank {r}:\n{o[-4000:]}"
            self.done[world] = torch.load(os.path.join(self.dirs[world], "out.pt"),
                                          weights_only=False)
        return self.done[world]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
