"""The B1 bound against PERF.md's table, and the operation counts against
hand counts at tiny sizes."""
import pytest
import torch

from portbench import flops


@pytest.mark.parametrize("shape, elem, ms", [
    ((128, 5, 16), 4, 0.000285), ((32, 5, 16), 4, 0.0000712), ((1024, 5, 16), 4, 0.00228),
    ((128, 5, 18), 4, 0.000356), ((32, 5, 18), 4, 0.0000891), ((64, 20, 18), 8, 0.00157),
])
def test_b1_bound_matches_the_kernel_table(shape, elem, ms):
    assert flops.b1_bound_s(*shape, elem) * 1e3 == pytest.approx(ms, rel=3e-3)


def test_b1_bound_depends_on_shape_and_dtype_alone():
    assert flops.b1_bound_s(256, 5, 16, 4) == pytest.approx(2 * flops.b1_bound_s(128, 5, 16, 4))
    assert flops.b1_bound_s(128, 5, 16, 8) == pytest.approx(2 * flops.b1_bound_s(128, 5, 16, 4))


def test_counter_matmul_conv_elementwise_reduction():
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    assert flops.count(lambda: a @ b) == 2 * 3 * 4 * 5
    assert flops.count(lambda: torch.bmm(torch.ones(2, 3, 4), torch.ones(2, 4, 5))) == 2 * 2 * 3 * 4 * 5
    conv = torch.nn.Conv1d(3, 8, 3, bias=False)
    # output (2, 8, 8): each element 3 x 3 multiply-adds
    assert flops.count(lambda: conv(torch.ones(2, 3, 10))) == 2 * (2 * 8 * 8) * 9
    x = torch.ones(6)
    assert flops.count(lambda: x * 2 + 1) == 12
    assert flops.count(lambda: x.sum()) == 6
    assert flops.count(lambda: x.reshape(2, 3).t().clone()) == 0


def test_b1_flops_by_hand():
    # T = 2, n = 3: 2 * 27 / 3 + 1 * 2 * 27 + 2 * 6 * 9 = 18 + 54 + 108 = 180
    assert flops.b1_flops(1, 2, 3) == pytest.approx(180)
    assert flops.b1_flops(5, 2, 3) == pytest.approx(900)


def test_newton_step_by_hand():
    # T = 2, nx = 2, nu = 1 (n = 3), a dynamics step of 10 operations
    T, nx, nu, f = 2, 2, 1, 10.0
    jac = 1 * 4 * 10                           # (T - 1) knots, 1 + n dynamics
    assemble = 2 * (2 * 2 * 9 + 4 * 2 * 3 + 2 * 9)
    merit = 1 * 10 + 2 * (4 * 3 + 6 * (2 + 2))
    res = 1 * 10 + 2 * 2 * 2
    want = jac + assemble + 180 + 20 * merit + res
    assert flops.newton_step_flops(T, nx, nu, f) == pytest.approx(want)
    tick = flops.tick_flops(4, rounds=3, net_round=100.0, T=T, nx=nx, nu=nu, f_dyn=f,
                            newton_steps=5, retries=2, al_iters=6)
    al = merit + res + 2 * 4 * (2 + 2)
    assert tick == pytest.approx(4 * (300 + 5 * want + 2 * 180 + 6 * al + 10))
