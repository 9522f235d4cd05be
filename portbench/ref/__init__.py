"""The benchmark's plain reference: what the two fleet cells run of the
port, one cold policy forward and one env step under inference mode, in
plain PyTorch and numpy. It imports nothing of the port, and holds only
that path: the base DEQ-MPC policy over the gcn trunk (Anderson's fixed
point with the phantom gradient's three applications, or one cell
application for deq-mpc-nn), the AL solve without streaming, estimator or
obstacles, the Newton steps with their jittered retry, the RexQuadrotor and
FlyingCartpole envs and the reader of the JAX package's checkpoints. It
differs from the port in three places:

  * the Newton systems are solved by the plain block-tridiagonal solve
    (`ops/tridiag.py`), never by the CUDA kernel;
  * the solver's batch-global decisions read the one process's batch (no
    process group);
  * the solver leaves the TF32 flags to its caller: the benchmark runs the
    reference with TF32 off (the configuration's f32) and its control with
    TF32 on.
"""
