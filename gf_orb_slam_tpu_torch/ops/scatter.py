"""Float scatter-adds that give the same bits on every call.

`Tensor.index_add_` on CUDA adds each source row into its target row with
an atomic add, so a row that takes three or more addends is summed in the
order the threads happen to reach it, and two calls on one input can part
in the last bits (two addends onto a zero row commute exactly). Such a
difference grows through an LM solve: two Schur or essential-graph solves
of one map then land apart.

Here the addends are put in row order once (a stable sort of the index,
`sum_plan`) and each row is added up one addend after the other in index
order (`planned_sum`, `torch.segment_reduce` over 2-D data, whose CUDA
kernel gives each (row, column) one thread that loops over the row's
addends). That is the order `index_add_` adds in on the CPU, so CPU results
keep their bits, and the card now gives the CPU's sums. A solve whose
index stays fixed across its iterations makes its plan once (an addend
that an iteration leaves out is added as 0).

Integer scatter-adds are exact in any order and need none of this.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SumPlan(NamedTuple):
    order: torch.Tensor    # (n,) addend positions in row order (a stable sort of the index)
    offsets: torch.Tensor  # (rows + 1,) where each row's addends start in `order`


def sum_plan(index: torch.Tensor, n_rows: int) -> SumPlan:
    """The plan of summing addends into `n_rows` rows by `index` (1-D
    int64, ≥ 0); an addend whose index is ≥ n_rows is dropped."""
    rows, order = torch.sort(index, stable=True)
    return SumPlan(order, torch.searchsorted(rows, torch.arange(n_rows + 1, device=index.device)))


def planned_sum(plan: SumPlan, src: torch.Tensor) -> torch.Tensor:
    """(rows, ...) the sums of src's (n, ...) rows by the plan's index, each
    row's addends added in index order, on every device; 0 where a row
    takes none."""
    # 2-D data: the CUDA kernel then gives each (row, column) one thread.
    flat = src.reshape(src.shape[0], math.prod(src.shape[1:])).index_select(0, plan.order)
    out = torch.segment_reduce(flat, "sum", offsets=plan.offsets, unsafe=True)
    return out.reshape((plan.offsets.shape[0] - 1,) + src.shape[1:])
