"""The train step with the elastic regularizer and the SE(3) or the
quaternion warp: the port's loss, every gradient and three Adam steps
against the JAX train step (the helpers, weights and tolerances of
``test_torch_elastic_train_step.py``). Cases: the SE(3) warp on the level path
with the Jacobian subsampled (K = 4) and on the per-module path (two GLO
tables, the Jacobian at every sample); the quaternion warp on the level path.
The warp heads are scaled up to rotation vectors of 0.1 to 1 rad, where the
port's retraction Jacobian (VJP rows, autograd) and the JAX side channel's
(``jax.jvp``) agree to rounding.
"""

import pytest

from tests.test_torch_elastic_train_step import (check_loss_and_gradients,
                                                 check_three_adam_steps)


@pytest.mark.parametrize('case', ['se3_k4', 'se3_modules', 'quaternion_k4'])
def test_loss_and_gradients_match_jax(case, monkeypatch):
    check_loss_and_gradients(case, monkeypatch)


def test_three_adam_steps_match_jax():
    check_three_adam_steps('se3_k4')
