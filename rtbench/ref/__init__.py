"""The plain reference: plain torch and NumPy on the benchmark's own
inputs. It imports nothing of the program."""
