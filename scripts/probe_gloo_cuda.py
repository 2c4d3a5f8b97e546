"""Which gloo collectives take CUDA tensors when two ranks share one card,
and whether NCCL forms a world of one rank.

    python3 scripts/probe_gloo_cuda.py

Each collective runs in a world of its own (two processes on card 0,
gloo over a file store), so one that crashes its ranks cannot hide the
others; each rank prints its result or its error. Then a one-rank NCCL
world all-reduces a tensor. Needs one CUDA card. The SPMD tier stages
through the host the collectives this shows gloo refusing
(``veles_tpu_torch/parallel/collectives.py`` ``GLOO_CUDA_STAGED``).
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

OPS = ["all_reduce", "broadcast", "all_gather", "all_to_all_single",
       "reduce_scatter_tensor", "batch_isend_irecv", "send_recv"]
CHILD = r'''
import sys, torch, torch.distributed as dist, datetime
op, rank, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
world = 2
dist.init_process_group("gloo", store=dist.FileStore(path, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
dev = torch.device("cuda", 0)
t = torch.full((8,), float(rank + 1), device=dev)
if op == "all_reduce":
    dist.all_reduce(t); out = t
elif op == "broadcast":
    dist.broadcast(t, 0); out = t
elif op == "all_gather":
    outs = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(outs, t); out = torch.cat(outs)
elif op == "all_to_all_single":
    out = torch.empty(16, device=dev)
    dist.all_to_all_single(out, torch.arange(16., device=dev) + 100 * rank)
elif op == "reduce_scatter_tensor":
    out = torch.empty(8, device=dev)
    dist.reduce_scatter_tensor(out, torch.ones(16, device=dev))
elif op == "batch_isend_irecv":
    out = torch.empty_like(t)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1 - rank),
                                     dist.P2POp(dist.irecv, out, 1 - rank)]):
        w.wait()
elif op == "send_recv":
    out = torch.empty_like(t)
    if rank == 0:
        dist.send(t, 1); dist.recv(out, 1)
    else:
        dist.recv(out, 0); dist.send(t, 0)
torch.cuda.synchronize()
print("RESULT", out.cpu().tolist())
dist.destroy_process_group()
'''


def main():
    import torch
    import torch.distributed as dist
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda, torch.cuda.get_device_name(0))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    tmp = tempfile.mkdtemp(prefix="probe_gloo_")
    t0 = time.time()
    procs = {}
    for op in OPS:
        path = os.path.join(tmp, op)
        procs[op] = [subprocess.Popen([sys.executable, "-c", CHILD, op,
                                       str(r), path],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for r in range(2)]
    for op, ps in procs.items():
        outs = []
        for p in ps:
            try:
                o, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                o, _ = p.communicate()
                o = "TIMEOUT " + (o or "")
            outs.append((p.returncode, o.strip().splitlines()[-3:]))
        print(op, json.dumps(outs))
    print("gloo probe s", time.time() - t0)
    t0 = time.time()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60),
        device_id=torch.device("cuda", 0))
    t = torch.arange(4., device="cuda")
    dist.all_reduce(t)
    print("nccl world1", t.cpu().tolist(), time.time() - t0)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
