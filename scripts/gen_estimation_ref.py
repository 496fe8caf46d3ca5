# Generate the oracle of the port's estimation step, computed by rmt_tpu
# (JAX) on the CPU in float64, and store it as a committed artifact
# (estimation_ref.npz at the repo root):
#
#     python scripts/gen_estimation_ref.py
#
# The configuration is scripts/bench_estimation.py's at B = 8 members:
# the DME case, N2, period 0.5 s, zNo 8, tNo 1, 12 fixed Radau steps
# (rmt_tpu.solvers.implicit_diff), T0 = 523 + linspace(-4, 4, 8), the log
# kinetic constants K1-K3 at 523 K, uniform target mole fractions, lr
# 1e-3. The file holds the configuration beside the results (theta_0,
# the targets, the loss, its gradients in the log constants, theta_new
# of make_estimation_step's step, and every member's outlet mole
# fractions at theta_0), so a reader can check that it ran what it
# holds. A few KB.

import math
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["RMT_TPU_X64"] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from rmt_tpu.models import homo
from rmt_tpu.parallel import batch_params
from rmt_tpu.parallel.estimation import (make_estimation_step,
                                         outlet_mole_fractions,
                                         simulate_n2_implicit)

B, PERIOD, Z_NO, N_STEPS, LR = 8, 0.5, 8, 12, 1e-3
RT = 8.314472 * 523.0
NAMES = ("K1", "K2", "K3")
THETA0 = np.array([
    math.log(35.45 * math.exp(-1.7069e4 / RT)),
    math.log(7.3976 * math.exp(-2.0436e4 / RT)),
    math.log(8.2894e4 * math.exp(-5.2940e4 / RT)),
])


def main():
    from dme_case import make_model_input

    assert jax.config.jax_enable_x64
    mi = make_model_input(model="N2", op_period=PERIOD)
    spec = homo.build_spec(mi, z_no=Z_NO, t_no=1)
    t0 = 523.0 + np.linspace(-4.0, 4.0, B)
    params, axes = batch_params(homo.build_params(mi),
                                {"T0": jnp.asarray(t0)})
    target = np.full((B, spec.n_comp), 1.0 / spec.n_comp)
    theta0 = {k: jnp.asarray(v) for k, v in zip(NAMES, THETA0)}
    rhs = homo.make_n2_rhs(spec)

    def loss_fn(th):
        def member(q):
            yf = simulate_n2_implicit(
                spec, q, {k: jnp.exp(th[k]) for k in NAMES}, N_STEPS,
                rhs=rhs)
            return outlet_mole_fractions(spec, yf)

        mf = jax.vmap(member, in_axes=(axes,))(params)
        return jnp.mean(jnp.sum((mf - target) ** 2, axis=-1)), mf

    (loss, mf), grads = jax.value_and_grad(loss_fn, has_aux=True)(theta0)
    step = make_estimation_step(spec, axes, jnp.asarray(target),
                                n_steps=N_STEPS, lr=LR, integrator="radau")
    theta_new, loss_step = step(theta0, params)
    assert abs(float(loss_step) - float(loss)) <= 1e-12 * float(loss)
    out = dict(
        names=np.array(NAMES), t0=t0, period=PERIOD, z_no=Z_NO,
        n_steps=N_STEPS, lr=LR, theta0=THETA0, target=target,
        loss=float(loss), grads=np.array([float(grads[k]) for k in NAMES]),
        theta_new=np.array([float(theta_new[k]) for k in NAMES]),
        outlet=np.asarray(mf))
    assert all(np.isfinite(v).all() for v in out.values()
               if isinstance(v, np.ndarray) and v.dtype.kind == "f")
    path = os.path.join(ROOT, "estimation_ref.npz")
    np.savez(path, **out)
    print(f"wrote {path}: loss {out['loss']:.12e}, grads {out['grads']}")


if __name__ == "__main__":
    main()
