"""The port's notebook figures (deepcgp_tpu_torch/utils/figures.py, no
plotting library) on the CPU: the inducing grid PNG equal to the JAX
package's ``inspect.inducing_patch_grid`` of the same snapshot, as uint8
levels upscaled; the scatter's and the curve's pixels of the right hue at
every projected point; the titles and values in tEXt chunks; and
``render_run_figures`` writing the file names the JAX package's
(matplotlib) ``render_run_figures`` writes for the same tiny model."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.utils import checkpoint as jckpt
from deepcgp_tpu.utils import inspect as jinspect

from deepcgp_tpu_torch.convert import from_jax_parameters
from deepcgp_tpu_torch.utils import events, figures
from deepcgp_tpu_torch.utils import inspect as insp

FLAGS = BuilderFlags(M='8,8', feature_maps='2', filter_sizes='5,3',
                     strides='2,1', num_samples=2, batch_size=8)
IMAGE = (12, 12, 1)


@functools.lru_cache(maxsize=None)
def _models():
    """The JAX model of tests/test_figures.py's geometry (float32), its
    snapshot loaded into the port, and the data."""
    rng = np.random.RandomState(0)
    X = rng.randn(32, *IMAGE).astype(np.float32)
    Y = rng.randint(0, 10, size=(32, 1))
    jmodel = jbuild(FLAGS, X, Y, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = from_jax_parameters(FLAGS, IMAGE,
                                jckpt.model_parameters(jmodel, 0),
                                num_data=32, device='cpu')
    return jmodel, model, X, Y


def _read(path):
    with open(path, 'rb') as f:
        raw = f.read()
    return events.decode_png(raw), events.png_text(raw)


def _frame(text):
    v = [float(x) for x in text['Frame'].split()]
    return (v[0], v[1]), (v[2], v[3]), tuple(int(x) for x in v[4:])


@pytest.mark.parametrize('layer', [0, 1])
def test_grid_png_equals_jax_grid(tmp_path, layer):
    jmodel, model, _, _ = _models()
    path = figures.render_inducing_grid(model.layers[layer],
                                        str(tmp_path / 'g.png'))
    pixels, text = _read(path)
    want = figures.grid_pixels(
        jinspect.inducing_patch_grid(jmodel.layers[layer]))
    scale = int(text['Scale'])
    assert scale == figures.grid_scale(want) and scale > 1
    want = np.repeat(np.repeat(want, scale, axis=0), scale, axis=1)
    assert pixels.shape == (*want.shape, 3)
    for c in range(3):
        np.testing.assert_array_equal(pixels[..., c], want)
    assert text['Title'] == 'Inducing patches (M=8)'


def test_scatter_hues_at_every_point(tmp_path):
    _, model, X, _ = _models()
    path = figures.render_patch_embedding(model.layers[0], X,
                                          str(tmp_path / 's.png'), seed=3)
    pixels, text = _read(path)
    emb_z, emb_d = insp.patch_embedding(model.layers[0], X, seed=3)
    xlim, ylim, box = _frame(text)
    zr, zc = figures.project(emb_z[:, 0], emb_z[:, 1], xlim, ylim, box)
    dr, dc = figures.project(emb_d[:, 0], emb_d[:, 1], xlim, ylim, box)
    assert (pixels[zr, zc] == figures.SECONDARY).all()
    # A data dot is covered only where an inducing dot (radius 3 and its
    # ring) lies over it.
    near = ((dr[:, None] - zr[None]) ** 2
            + (dc[:, None] - zc[None]) ** 2 <= 4 * 4 + 4).any(1)
    assert (pixels[dr[~near], dc[~near]] == figures.PRIMARY).all()
    assert (~near).sum() > len(dr) // 2
    assert text['Title'] == 'Patch embedding: inducing vs data'
    # The data limits hold every point inside the plot box.
    left, top, right, bottom = box
    assert (left <= dc).all() and (dc <= right).all()
    assert (top <= dr).all() and (dr <= bottom).all()


def test_curve_hue_and_values(tmp_path):
    accs = {0.0: 0.98, 0.25: 0.931, 0.5: 0.9, 1.0: 0.6}
    path = figures.render_noise_robustness(accs, str(tmp_path / 'n.png'))
    pixels, text = _read(path)
    xlim, ylim, box = _frame(text)
    assert ylim == (0.0, 1.05)
    rows, cols = figures.project(np.array(list(accs)),
                                 np.array(list(accs.values())), xlim, ylim, box)
    assert (pixels[rows, cols] == figures.PRIMARY).all()
    # The line between two markers is drawn too.
    mr, mc = (rows[0] + rows[1]) // 2, (cols[0] + cols[1]) // 2
    assert (pixels[mr - 1:mr + 2, mc - 1:mc + 2] == figures.PRIMARY).all(-1).any()
    assert text['Title'] == 'Noise robustness'
    assert text['X label'] == 'input noise sigma'
    assert text['Y label'] == 'test accuracy'
    assert {k: v for k, v in text.items() if k.startswith('sigma=')} == {
        'sigma=0': '0.980', 'sigma=0.25': '0.931', 'sigma=0.5': '0.900',
        'sigma=1': '0.600'}


def test_render_run_figures_names_equal_jax(tmp_path):
    pytest.importorskip('matplotlib')
    from deepcgp_tpu.utils import figures as jfigures
    jmodel, model, X, Y = _models()
    jdir, pdir = tmp_path / 'jax', tmp_path / 'port'
    jdir.mkdir()
    pdir.mkdir()
    jpaths = jfigures.render_run_figures(
        str(jdir), jmodel, X, X.reshape(32, -1), Y, jax.random.PRNGKey(1),
        noise_levels=(0.0, 0.5), max_eval_points=16)
    paths = figures.render_run_figures(
        str(pdir), model, X, X.reshape(32, -1), Y, 1,
        noise_levels=(0.0, 0.5), max_eval_points=16)
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in jpaths]
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for p in paths:
        pixels, text = _read(p)
        assert pixels.shape[2] == 3 and 'Title' in text
    _, text = _read(str(pdir / 'noise_robustness.png'))
    assert set(text) >= {'sigma=0', 'sigma=0.5'}
