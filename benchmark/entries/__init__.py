"""Window loops, one module per traffic ``entry``: ``fit`` (training
through ``trainer.fit``) and ``solve`` (rollouts through ``rollout.solve``).
Each has ``run(ctx) -> harness.Outcome``."""
