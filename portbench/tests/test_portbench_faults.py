"""The harness on the CPU at a tiny size, past its look for a card: a
sound run comes out correct, and each fault a cell of this benchmark can
have, planted in the timed path underneath, comes out not correct.  (No
cell runs on more than one chip, so no exchange between chips can be
left out.)"""

import pytest
import torch

from portbench import harness

SEED = 2 ** 31 + 77


def run(spec):
    return harness.run_cell(spec, SEED, 0.3, False, 'cpu')


@pytest.mark.parametrize('kind', ['train', 'serve'])
def test_a_sound_run_is_correct(tiny_spec, kind):
    out = run(tiny_spec(kind))
    assert out['correct'], out['checks']
    assert out['failed'] == 0 and out['attempted'] > 0
    assert list(out)[-1] == 'checks'
    names = {'train': {'loss_rel', 'grad_gap', 'change_gap',
                       'grad_err_median'},
             'serve': {'prob_gap'}}[kind]
    assert set(out['checks']) == names


def test_a_step_that_leaves_its_state_unchanged(tiny_spec, monkeypatch):
    from deepcgp_tpu_torch.training import trainer

    def unchanged(state, config, xb, yb, noise=None):
        loss, _ = trainer.loss_and_grads(state, xb, yb, noise)
        state.step.add_(1)
        return -loss
    monkeypatch.setattr(trainer, 'train_step', unchanged)
    out = run(tiny_spec('train'))
    assert not out['correct']
    assert out['checks']['grad_gap']['value'] >= 0.99


def test_half_of_the_batch_left_out(tiny_spec, monkeypatch):
    from deepcgp_tpu_torch.models.dgp import DGP
    elbo = DGP.elbo

    def half(self, X, Y, **draw):
        n = X.shape[0] // 2
        return elbo(self, X[:n], Y[:n], **draw)
    monkeypatch.setattr(DGP, 'elbo', half)
    assert not run(tiny_spec('train'))['correct']


def test_an_answer_altered_where_it_is_produced(tiny_spec, monkeypatch):
    from deepcgp_tpu_torch.models.dgp import DGP
    predict_y = DGP.predict_y

    def altered(self, X, S, **draw):
        mean, var = predict_y(self, X, S, **draw)
        mean = mean.clone()
        mean[:, 0] = torch.roll(mean[:, 0], 1, -1)
        return mean, var
    monkeypatch.setattr(DGP, 'predict_y', altered)
    assert not run(tiny_spec('serve'))['correct']
