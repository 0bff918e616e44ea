"""The program under test, ``deepcgp_tpu_torch``, reached only through its
user entry points: the builder, ``training.trainer`` (``init_state``,
``run_chunk``) and ``serving.Predictor.from_run_dir``.  The port is
imported inside these functions, never when this module is imported."""

from __future__ import annotations

import os
import types

import numpy as np


def build_kernels() -> float:
    """Build the port's CUDA libraries that are not built yet (into the
    checkout's ``build/cuda``); the seconds it took."""
    import time

    from deepcgp_tpu_torch.ops import cuda_build
    t = time.perf_counter()
    cuda_build.build()
    return time.perf_counter() - t


def flags(config: dict, samples: int) -> types.SimpleNamespace:
    """The training CLI's flags of a configuration file."""
    def ints(values):
        return ','.join(str(x) for x in values)
    return types.SimpleNamespace(
        M=ints(config['M']), feature_maps=ints(config['feature_maps']),
        filter_sizes=ints(config['filter_sizes']),
        strides=ints(config['strides']), base_kernel=config['base_kernel'],
        last_kernel=config['last_kernel'], white=config['white'],
        identity_mean=config['identity_mean'], num_samples=samples)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def snapshot(weights: list) -> dict:
    """The weights as the reference-format snapshot (``<name>.npy``) holds
    them."""
    out = {'global_step': 0}
    for i, w in enumerate(weights):
        pre = f'DGP/layers/{i}/'
        out[pre + 'feature/Z'] = _host(w['Z'])
        out[pre + 'q_mu'] = _host(w['q_mu'])
        out[pre + 'q_sqrt'] = _host(w['q_sqrt'])
        out[pre + 'kern/base_kernel/variance'] = np.float64(w['variance'])
        out[pre + 'kern/base_kernel/lengthscales'] = np.float64(
            w['lengthscale'])
        if 'patch_weights' in w:
            out[pre + 'kern/patch_weights'] = _host(w['patch_weights'])
    return out


def training_model(config: dict, weights: list, samples: int, device):
    """The model of a configuration with the given weights, through the
    port's builder, for a training set of ``num_data`` rows."""
    from deepcgp_tpu_torch.models.builder import build_model
    from deepcgp_tpu_torch.utils.checkpoint import parse_layer_parameters
    _, loaded = parse_layer_parameters(snapshot(weights), len(config['M']))
    return build_model(flags(config, samples), tuple(config['image_shape']),
                       loaded, num_data=config['num_data'], device=device)


def training_state(model, config: dict, traffic: dict, seed: int):
    """(TrainState, TrainConfig): the optimizer's state from ``seed``,
    which seeds the stream the minibatches and the noise come from."""
    from deepcgp_tpu_torch.training import trainer
    tc = trainer.TrainConfig(optimizer=traffic['optimizer'], lr=config['lr'],
                             lr_decay_steps=config['lr_decay_steps'],
                             lr_staircase=not config['lr_decay_continuous'],
                             batch_size=traffic['batch'])
    return trainer.init_state(model, tc, seed=seed), tc


def run_chunk(state, tc, X, Y, steps: int):
    """``steps`` optimizer steps, the graphed default; the ELBO trace."""
    from deepcgp_tpu_torch.training import trainer
    return trainer.run_chunk(state, tc, X, Y, steps)


def write_run(root: str, config: dict, weights: list, samples: int) -> str:
    """A run directory as the training CLI leaves it: ``<root>/<name>.npy``
    beside ``<root>/<name>/options.toml``."""
    name = 'snapshot'
    np.save(os.path.join(root, name + '.npy'),
            np.asarray(snapshot(weights), dtype=object))
    run = os.path.join(root, name)
    os.makedirs(run)
    lines = [f'name = "{name}"']
    for k, v in vars(flags(config, samples)).items():
        lines.append(f'{k} = {str(v).lower()}' if isinstance(v, bool)
                     else f'{k} = {v}' if isinstance(v, int)
                     else f'{k} = "{v}"')
    with open(os.path.join(run, 'options.toml'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return run


def predictor(run_dir: str, config: dict, traffic: dict, seed: int, device):
    """The served model, loaded from the run directory."""
    from deepcgp_tpu_torch.serving import Predictor
    return Predictor.from_run_dir(run_dir, tuple(config['image_shape']),
                                  batch_size=traffic['rows'],
                                  num_samples=traffic['samples'], seed=seed,
                                  device=device)


def release(device) -> None:
    """Give the program's freed memory back to the device."""
    import gc

    import torch
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
