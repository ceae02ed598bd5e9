"""``python tests/torch_train_cli.py ARGS``: ``hypernerf_tpu_torch.train.
main(ARGS)`` with TensorBoard's import blocked (it takes some 20 s on the
CPU), in this process and in each rank it spawns: a spawned rank runs this
file's top level again before it runs ``main``. The CSV is what the tests
read."""

import os
import sys

sys.modules['torch.utils.tensorboard'] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == '__main__':
    from hypernerf_tpu_torch import train
    train.main(sys.argv[1:])
