"""Checkpoints (counterpart of ``deepcgp_tpu/utils/checkpoint.py``).

A reference-format snapshot is ``np.save`` of a flat {pathname:
constrained value} dict plus ``global_step``, with the reference's
``DGP/layers/<i>/<param>`` pathnames, so a snapshot written by the JAX
package loads here and back.

A full-state snapshot (``--full-state-ckpt``) is one ``torch.save`` of the
whole ``TrainState`` -- the model's parameters and buffers, the optimizer
moments and count, the generator state, the step and NatGrad's backoff
counter and verified parameters -- as ``state_<step>.pt``, so a resumed run
continues bit for bit.  Its format is the port's own.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from deepcgp_tpu_torch.models.base_kernels import ArcCosine
from deepcgp_tpu_torch.models.layers import ConvLayer


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def model_parameters(model, global_step: int) -> dict:
    """Flat {pathname: constrained value} dict (+ global_step).  Z0 and
    the identity mean's filter are not saved: a restart re-anchors the KL
    prior at the loaded Z and rebuilds the delta filter, as the reference
    does."""
    params = {}
    for i, layer in enumerate(model.layers):
        prefix = f'DGP/layers/{i}/'
        params[prefix + 'q_mu'] = _np(layer.q_mu)
        params[prefix + 'q_sqrt'] = np.tril(_np(layer.q_sqrt))
        params[prefix + 'feature/Z'] = _np(layer.Z)
        kern_prefix = prefix + 'kern/base_kernel/'
        if isinstance(layer, ConvLayer):
            base = layer.base_kernel
        elif hasattr(layer.kernel, 'base_kernel'):
            base = layer.kernel.base_kernel
            params[prefix + 'kern/patch_weights'] = _np(layer.kernel.patch_weights)
        else:
            # A plain last-layer kernel: gpflow's pathnames of a bare RBF
            # have no 'base_kernel/' segment.
            base = layer.kernel
            kern_prefix = prefix + 'kern/'
        params[kern_prefix + 'variance'] = _np(base.variance)
        if isinstance(base, ArcCosine):
            params[kern_prefix + 'weight_variances'] = _np(base.weight_variances)
            params[kern_prefix + 'bias_variance'] = _np(base.bias_variance)
        else:
            params[kern_prefix + 'lengthscales'] = _np(base.lengthscales)
    params['global_step'] = int(global_step)
    return params


def save_model(path: str, model, global_step: int) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.save(path, np.asarray(model_parameters(model, global_step), dtype=object))


def load_raw(path: str) -> dict:
    """The snapshot's dict.  It is a pickled object array: load only
    snapshots this program or the JAX package wrote."""
    return np.load(path, allow_pickle=True).item()


def parse_layer_parameters(parameters: dict, model_layers: int):
    """Pathnames -> per-layer dicts, with the shallower-to-deeper remap
    (the stored last layer moves into the new last slot).  Returns
    (global_step, {layer_index: params})."""
    parameters = dict(parameters)
    global_step = int(parameters.pop('global_step', 0))
    layer_params = {}
    for key, value in parameters.items():
        if 'layers' not in key:
            continue
        parts = key.split('/')
        path = '/'.join(parts[3:])
        values = layer_params.setdefault(int(parts[2]), {})
        # Priority matching of the reference loader.
        for name in ('q_mu', 'q_sqrt', 'Z', 'base_kernel/weight_variances',
                     'base_kernel/bias_variance', 'base_kernel/variance',
                     'base_kernel/lengthscales', 'patch_weights',
                     'lengthscales', 'weight_variances', 'bias_variance',
                     'variance'):
            if name in path:
                values[name] = value
                break
    stored_layers = max(layer_params.keys()) + 1
    if stored_layers > model_layers:
        raise ValueError("can't load a deeper checkpoint into a shallower model")
    if stored_layers != model_layers:
        layer_params[model_layers - 1] = layer_params.pop(stored_layers - 1)
    return global_step, layer_params


def load_layer_parameters(path: str, model_layers: int):
    return parse_layer_parameters(load_raw(path), model_layers)


# ------------------------------------------------------------ full state

_STATE_RE = re.compile(r'^state_(\d+)\.pt$')


def save_train_state(directory: str, state, *, keep: int = 3) -> None:
    """Write the full TrainState to ``directory/state_<step>.pt``: saved
    under a temporary name and renamed, so a crash mid-save leaves no
    snapshot that ``latest_train_state_step`` would pick.  Only the
    ``keep`` newest snapshots stay."""
    os.makedirs(directory, exist_ok=True)
    step = int(state.step)
    payload = {'model': state.model.state_dict(),
               'opt_state': {k: v for k, v in state.opt_state.items()
                             if k != 'salt_index'},
               'step': state.step, 'steps_back': state.steps_back,
               'prev': state.prev, 'generator': state.generator.get_state()}
    path = os.path.join(directory, f'state_{step}.pt')
    tmp = f'{path}.tmp-{os.getpid()}'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in sorted(_complete_snapshots(directory))[:-keep]:
        os.remove(os.path.join(directory, f'state_{old}.pt'))


def _complete_snapshots(directory: str) -> list:
    """Steps of the fully written snapshots (temporary files excluded)."""
    return [int(m.group(1)) for m in map(_STATE_RE.match,
                                         os.listdir(directory)) if m]


def latest_train_state_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _complete_snapshots(directory)
    return max(steps) if steps else None


def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f'{what}: the snapshot holds {sorted(src)}, the '
                         f'state {sorted(dst)}')
    for k, t in dst.items():
        t.copy_(src[k])


@torch.no_grad()
def restore_train_state(directory: str, state):
    """Restore the newest full snapshot into ``state`` (a freshly built
    TrainState of the same model, optimizer and device), in place, and
    return it.  Each tensor is copied into the state's own, so a moment
    stored in another dtype is cast to the state's, and every tensor keeps
    its storage: the state's captured graphs (``state.graphs``) read the
    restored values.  The generator's state is set in place too, which a
    generator registered with those graphs takes at its next replay."""
    step = latest_train_state_step(directory)
    if step is None:
        raise FileNotFoundError(f'no state_*.pt snapshots under {directory}')
    saved = torch.load(os.path.join(directory, f'state_{step}.pt'),
                       map_location='cpu', weights_only=True)
    state.model.load_state_dict(saved['model'])
    opt = saved['opt_state']
    if 'count' in state.opt_state:
        state.opt_state['count'].copy_(opt['count'])
        _copy_into(state.opt_state['mu'], opt['mu'], 'Adam mu')
        _copy_into(state.opt_state['nu'], opt['nu'], 'Adam nu')
    elif opt:
        raise ValueError('the snapshot holds optimizer moments the state '
                         'has no place for')
    state.step.copy_(saved['step'])
    if (saved['steps_back'] is None) != (state.steps_back is None):
        raise ValueError('the snapshot and the state differ in optimizer')
    if state.steps_back is not None:
        state.steps_back.copy_(saved['steps_back'])
        _copy_into(state.prev, saved['prev'], 'NatGrad prev')
    state.generator.set_state(saved['generator'])
    return state
