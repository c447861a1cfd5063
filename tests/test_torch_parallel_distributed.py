"""``parallel/distributed.py`` run for real: two processes join one
``gloo`` process group over local TCP (``initialize``), all-reduce a
tensor, agree on the main process, and take their ranks' shares of one
manifest through ``ExpansionDriver``'s rule; the shares are disjoint and
their union is the one-process manifest. A single process with no
coordinator initialises nothing, as in the JAX package."""

import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from distdiff_tpu_torch.parallel import distributed
from distdiff_tpu_torch.parallel.driver import rank_share
from distdiff_tpu_torch.parallel.manifest import build_manifest

pid, port = int(sys.argv[1]), sys.argv[2]
distributed.initialize(f"127.0.0.1:{{port}}", num_processes=2, process_id=pid)
assert distributed.process_count() == 2 and distributed.process_index() == pid
t = torch.full((4,), float(pid + 1), requires_grad=True)
total = distributed.all_reduce_sum(t)
total.sum().backward()
units = build_manifest([f"/d/img_{{i}}.png" for i in range(7)], ["c"] * 7, "/out", 3)
print(json.dumps({{"pid": pid, "main": distributed.is_main_process(),
                   "sum": total.tolist(), "grad": t.grad.tolist(),
                   "share": [[u.dataset_index, u.image_i] for u in rank_share(units)]}}))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_reduce_and_share_the_manifest(tmp_path):
    from distdiff_tpu_torch.parallel import distributed
    from distdiff_tpu_torch.parallel.driver import rank_share
    from distdiff_tpu_torch.parallel.manifest import build_manifest

    distributed.initialize()  # one process, no coordinator: nothing to join
    assert distributed.process_count() == 1 and distributed.is_main_process()
    units = build_manifest([f"/d/img_{i}.png" for i in range(7)], ["c"] * 7, "/out", 3)
    assert rank_share(units) == units

    child = tmp_path / "child.py"
    child.write_text(CHILD.format(root=ROOT))
    env = dict(os.environ, DISTDIFF_PLATFORM="cpu", OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(child), str(pid), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for pid in (0, 1)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    res = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        r = json.loads(out.strip().splitlines()[-1])
        res[r["pid"]] = r
    assert res[0]["main"] and not res[1]["main"]
    for r in res.values():
        assert r["sum"] == [3.0] * 4  # 1 + 2 on every rank
        assert r["grad"] == [2.0] * 4  # the sum's transpose: both ranks' cotangents
    shares = [tuple(u) for r in (res[0], res[1]) for u in r["share"]]
    assert len(shares) == len(set(shares)) == len(units)
    assert sorted(shares) == sorted((u.dataset_index, u.image_i) for u in units)
