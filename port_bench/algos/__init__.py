"""One adaptor a learner: how the harness builds the program through the
port's own CLI builder, draws the iteration's inputs, drives one
iteration (whole, or as rollout and update apart for the traced run), and
what it records of the env step for the reference."""
