"""Training of the LM and MIND substrate on the port: the AdamW and SGD
optimizers, the train steps with microbatch accumulation, checkpoints in
the reference's on-disk layout, and the restartable loop."""
