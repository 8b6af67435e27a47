"""One torch thread per test worker for the port's CPU tests.

The tier runs 6 pytest workers on this machine's 8 cores, and torch
starts one OpenMP thread per core in each: 48 threads on 8 cores, under
which a port test runs up to 40x slower than alone (measured:
``test_accum_step_equals_its_manual_reference[mygan-bfloat16]`` 0.86 s
alone, 144 s in the tier; the port's files 895 s with 6 workers, 197 s
with one thread each).  A port test module that imports
``one_torch_thread`` runs its tests on one torch thread and gives the
worker its thread count back after them.  Three do not, because what
they hold depends on the order of torch's float32 sums:
``test_torch_port_train.py`` (its float32-against-float64 check of the
discriminator states the error of torch's multi-threaded sums: 1.1e-5
within 2e-5; 3.2e-5 on one thread), ``test_torch_port_bf16_nets.py`` and
``test_torch_port_bf16_gan_step.py`` (a bfloat16 train-mode forward of
Xception and the ``--ae`` step against JAX: on one thread the sums round
otherwise and the train-mode BatchNorms carry that past 2^-7).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_module_runs_torch_on_one_thread():
    assert torch.get_num_threads() == 1
