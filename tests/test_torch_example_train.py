"""``examples/torch_train_lm.py --device cpu`` at the reference's CI scale
(20 steps of 4 x 64 on xlstm-125m at a quarter of its width, float32),
its ``Trainer`` started from the JAX package's ``init_params(PRNGKey(0))``
(what the reference's ``Trainer`` makes at seed 0): the reference's
``Trainer`` on the batches the port's pipeline delivered (in the order it
delivered them) gives each step's loss within the trajectory tolerance of
``test_torch_train.py`` (1e-5), and the loss falls, as the reference
example's docstring promises."""

import numpy as np

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.training.optimizer import OptConfig as JaxOptConfig
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.training import optimizer as TO
from torch_examples import jax_twin, jax_weights, load

TOL = 1e-5
CI = ["--steps", "20", "--scale", "0.25", "--batch", "4", "--seq", "64"]


def test_train_lm_matches_the_reference_trainer(tmp_path):
    port = load("torch_train_lm")
    runs = []

    class Recorded(port.Trainer):
        def __init__(self, cfg, opt_cfg, **kw):
            super().__init__(cfg, opt_cfg, **kw)
            self.params = jax_weights(jax_twin(cfg, JaxModelConfig), self.seed)
            self.opt_state = TO.init(self.params, opt_cfg)
            self.batches = []
            runs.append(self)

        def fit(self, data_iter, num_steps, **kw):
            def kept():
                for b in data_iter:
                    self.batches.append(b)
                    yield b
            return super().fit(kept(), num_steps, **kw)

    port.Trainer = Recorded
    port.main(CI + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "torch")])
    (tr,) = runs
    assert tr.step == 20 and len(tr.batches) == 20
    jtr = JaxTrainer(jax_twin(tr.cfg, JaxModelConfig), jax_twin(tr.opt_cfg, JaxOptConfig),
                     ckpt_dir=str(tmp_path / "jax"), ckpt_every=50, seed=tr.seed)
    jtr.fit(iter(tr.batches), 20)
    np.testing.assert_allclose(tr.history, jtr.history, atol=TOL, rtol=TOL)
    assert tr.history[-1] < tr.history[0]
