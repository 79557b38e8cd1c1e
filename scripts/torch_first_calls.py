"""The first call of each of a training step's pieces in a fresh process on
cuda:0, and the second: torch.utils.checkpoint (non-reentrant), a batched
triangular solve, rms_norm, the short conv and the plain chunk rule's
forward and backward. A spawned rank pays the first calls once.

    python scripts/torch_first_calls.py   # on a machine with an NVIDIA GPU
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)


def timed(name, fn, n=2):
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"{name} #{i + 1}: {time.perf_counter() - t0:.3f} s", flush=True)


x = torch.randn(64, 64, device=dev, requires_grad=True)
from torch.utils.checkpoint import checkpoint
timed("checkpoint non-reentrant", lambda: checkpoint(lambda t: (t * 2).sin(), x, use_reentrant=False).sum().backward())
a = torch.tril(torch.randn(8, 16, 64, 64, device=dev), -1)
timed("solve_triangular", lambda: torch.linalg.solve_triangular(a, torch.randn(8, 16, 64, 64, device=dev), upper=False, unitriangular=True))
timed("import torch._dynamo", lambda: __import__("torch._dynamo"), 1)
from infinitevl_tpu_torch.ops.norms import rms_norm
w = torch.ones(2048, device=dev, dtype=torch.bfloat16)
h = torch.randn(1, 2048, 2048, device=dev, dtype=torch.bfloat16)
timed("rms_norm", lambda: rms_norm(h, w, 1e-6))
from infinitevl_tpu_torch.ops.short_conv import causal_conv1d
r = torch.randn(1, 2048, 2048, device=dev, dtype=torch.bfloat16)
cw = torch.randn(4, 2048, device=dev, dtype=torch.bfloat16)
timed("causal_conv1d", lambda: causal_conv1d(r, cw, None))
from infinitevl_tpu_torch.ops.delta_rule import delta_rule_chunk
H, K, V = 16, 128, 256
q = torch.nn.functional.normalize(torch.randn(1, 2048, H, K, device=dev), dim=-1).requires_grad_()
k = torch.nn.functional.normalize(torch.randn(1, 2048, H, K, device=dev), dim=-1).requires_grad_()
v = torch.randn(1, 2048, H, V, device=dev, requires_grad=True)
g = (-torch.rand(1, 2048, H, device=dev) * 0.1).requires_grad_()
beta = torch.rand(1, 2048, H, device=dev, requires_grad=True)
timed("plain chunk rule fwd+bwd fp32", lambda: sum(t.float().sum() for t in delta_rule_chunk(q, k, v, g, beta, None, None, True, 64, compute_dtype=torch.float32)).backward())
