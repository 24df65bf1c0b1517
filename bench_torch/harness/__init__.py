"""The benchmark's yardstick: traffic generation, the seeded clock, the
end-to-end arithmetic, the trace reduction, the plain reference's check and
the cells' manifest. Nothing here imports the JAX package or jax; the
program under test (``rust_renderer_tpu_torch``) is imported only by
`session`, and the reference (``rrt_reference``) only by `check`."""
