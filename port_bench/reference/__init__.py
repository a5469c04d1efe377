"""The plain reference that decides `correct`: the learners' rollout
forwards and updates in plain torch (one module per learner), and a frozen
copy of the port's plain env step (`frozen/`). Imports nothing of the
port, of the JAX package or of JAX."""
