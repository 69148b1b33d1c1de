"""Batched + sharded scenario solving (a new capability; the
reference is single-process).  A whole pendulum swing-up trajopt solve is
vmapped over a scenario batch of initial states and optionally sharded
over every available device.

Run:  python examples/batched_scenarios.py [batch_size]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# float64 on every platform: the examples run at the reference's f64
# tolerances
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from calipso_tpu import TrajOptSolver, Options
from calipso_tpu.models import pendulum


def main(batch=256):
    prob = pendulum.swingup_problem(horizon=11, parametric_initial_state=True)
    kw = {
        k: v
        for k, v in prob.items()
        if k not in ("state_guess", "state_initial", "state_goal")
    }
    ts = TrajOptSolver(options=Options(), **kw)
    xg = np.array([np.pi, 0.0])
    ts.initialize_states([xg * t / 10 for t in range(11)])
    bts = ts.batched()

    rng = np.random.default_rng(0)
    x0s = jnp.asarray(0.2 * rng.normal(size=(batch, 2)))

    # single-device vmap
    res = bts.solve(parameters=x0s)
    jax.block_until_ready(res.state.p.x)
    t0 = time.time()
    res = bts.solve(parameters=x0s)
    jax.block_until_ready(res.state.p.x)
    dt = time.time() - t0
    print(f"vmap: {int(jnp.sum(res.state.solved))}/{batch} solved, "
          f"{batch / dt:.0f} solves/s on {jax.devices()[0].device_kind}")

    # sharded over all devices (no-op on one chip; spreads on a mesh)
    devs = jax.devices()
    if len(devs) > 1 and batch % len(devs) == 0:
        mesh = Mesh(np.array(devs), axis_names=("batch",))
        res_sh = bts.solve(parameters=x0s, mesh=mesh)
        jax.block_until_ready(res_sh.state.p.x)
        print(f"sharded over {len(devs)} devices: "
              f"{int(jnp.sum(res_sh.state.solved))}/{batch} solved")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
