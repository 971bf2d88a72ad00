"""The GPipe schedule that ``parallel/sp.py`` (time segments, carries sent
up) and ``parallel/pp.py`` (layer blocks, hidden sequences sent up) share.

The ranks of one mesh axis form a chain: rank r receives what rank r - 1
sends and sends to rank r + 1. A step's work is cut into chunks, each run
with its own autograd graph. The forward runs chunks 0..C-1: receive the
chunk's input from r - 1, run it, send its output to r + 1. The backward
runs chunks C-1..0: receive the cotangent of the sent output from r + 1,
back-propagate it together with the chunk's objective and the cotangent of
the carry that chunk k + 1 handed back, send the cotangent of the received
input to r - 1. That is the transpose ``jax.grad`` takes through
``ppermute``, in an order the program fixes rather than the autograd
engine, so the sends and receives of two ranks cannot wait on each other.
With one rank nothing is sent.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import mesh as mesh_mod


def grad_or_zeros(x: torch.Tensor) -> torch.Tensor:
    """The gradient autograd left in the leaf ``x``, or zeros where nothing
    reached it."""
    return torch.zeros_like(x) if x.grad is None else x.grad


def _wait(requests):
    for req in requests:
        req.wait()


def gpipe(n_chunks: int, run_chunk: Callable, recv_like: torch.Tensor,
          axis: Optional[mesh_mod.AxisGroup],
          carry: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Run ``n_chunks`` chunks forward and back on this rank of ``axis``
    (None: one rank), leaving the gradients in the leaves ``run_chunk``
    reads; returns the last chunk's carry, detached (None without one).

    ``run_chunk(k, x_in, carry_in)`` runs chunk k and returns (its
    objective or None, the tensor sent up to r + 1, its carry out or
    None). ``x_in`` is what r - 1 sent for chunk k, a leaf of
    ``recv_like``'s shape and type that requires grad (None on rank 0);
    ``carry_in`` is ``carry`` at k = 0 and after that the carry chunk k -
    1 returned, detached into a leaf that requires grad (None throughout
    when ``carry`` is None)."""
    n, r = (1, 0) if axis is None else (axis.size, axis.rank)
    first, last = r == 0, r == n - 1
    carried = carry is not None
    chunks, sends = [], []
    with torch.enable_grad():
        for k in range(n_chunks):
            x_in = (None if first else
                    mesh_mod.recv(recv_like, r - 1, axis).requires_grad_())
            carry_in = (carry if k == 0 or not carried
                        else carry.detach().requires_grad_())
            objective, up, carry = run_chunk(k, x_in, carry_in)
            if not last:
                sends.append(mesh_mod.send(up.detach(), r + 1, axis))
            chunks.append((objective, up, carry, x_in, carry_in))
        _wait(sends)
        sends, d_carry = [], None
        for k in reversed(range(n_chunks)):
            objective, up, carry_out, x_in, carry_in = chunks[k]
            chunks[k] = None
            outs, cots = [], []
            if objective is not None:
                outs.append(objective)
                cots.append(torch.ones_like(objective))
            if not last:
                outs.append(up)
                cots.append(mesh_mod.recv(up, r + 1, axis))
            if d_carry is not None:
                outs.append(carry_out)
                cots.append(d_carry)
            if outs:
                torch.autograd.backward(outs, cots)
            if carried and k > 0:
                d_carry = grad_or_zeros(carry_in)
            if not first:
                sends.append(mesh_mod.send(grad_or_zeros(x_in), r - 1, axis))
    _wait(sends)
    return None if carry is None else carry.detach()
