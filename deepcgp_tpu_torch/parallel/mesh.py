"""The process mesh (counterpart of ``deepcgp_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ('data', 'model') mesh and lets
the partitioner split a jitted program over it.  The port runs one process
per rank and makes the split explicit (``parallel.sharding``):

* ``data`` -- the rows of the global batch, and of its Monte-Carlo noise,
  are split over the data ranks; the gradients are summed over the data
  group after backward;
* ``model`` -- a conv layer's patch axis P, and the last layer's GP axis R
  of the q_sqrt term and of the KL, are split over the model group; the
  inducing axis M stays replicated (NatGrad's solve and the Kuu factor
  run on every rank).

Ranks are laid out row-major as (data, model), as the JAX mesh reshapes
its device list: rank = data_rank * model + model_rank.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from deepcgp_tpu_torch.parallel import multihost

AXES = ('data', 'model')


def parse_mesh_spec(spec: str) -> dict:
    """'data=4,model=2' -> {'data': 4, 'model': 2}."""
    out = {}
    if not spec:
        return out
    for part in spec.split(','):
        name, size = part.split('=')
        out[name.strip()] = int(size)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) mesh of processes.  The groups
    are None when no process group is initialised (a one-rank mesh): every
    collective is then skipped."""

    data: int
    model: int
    rank: int
    world_size: int
    data_group: object = None      # the ranks that share this model_rank
    model_group: object = None     # the ranks that share this data_rank
    axis_names = AXES

    @property
    def shape(self) -> dict:
        return {'data': self.data, 'model': self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    def rows(self, n: int) -> slice:
        """This data rank's rows of ``n`` global rows (an even split)."""
        if n % self.data:
            raise ValueError(f'{n} rows do not split over the data axis of '
                             f'size {self.data}')
        per = n // self.data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)


def make_mesh(spec: str | dict | None = None) -> Mesh:
    """The mesh of ``spec`` over the initialised process group (or over the
    one process when there is none).  With no spec every rank goes to
    'data'.  Raises on an unknown axis, and when the spec does not cover
    the world exactly: a spec larger than the world cannot run, and ranks
    left outside the mesh would have nothing to do."""
    if isinstance(spec, str):
        spec = parse_mesh_spec(spec)
    world, rank = multihost.world()
    if not spec:
        spec = {'data': world}
    unknown = set(spec) - set(AXES)
    if unknown:
        raise ValueError(f'unknown mesh axes {sorted(unknown)}; valid: data, '
                         'model')
    n_data, n_model = int(spec.get('data', 1)), int(spec.get('model', 1))
    if n_data < 1 or n_model < 1:
        raise ValueError(f'mesh {spec}: every axis needs at least one rank')
    if n_data * n_model != world:
        raise ValueError(f'mesh {spec} needs {n_data * n_model} ranks, the '
                         f'world has {world}')
    data_group = model_group = None
    if multihost.initialised():
        # Every rank creates every group, in the same order.
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                model_group = g
    return Mesh(n_data, n_model, rank, world, data_group, model_group)


def shard_batch(mesh: Mesh, *arrays):
    """This data rank's rows of each global-batch array (the counterpart
    of placing the batch with ``batch_sharding``)."""
    out = tuple(a[mesh.rows(a.shape[0])] for a in arrays)
    return out if len(out) > 1 else out[0]
