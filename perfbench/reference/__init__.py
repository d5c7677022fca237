"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy: nothing here imports the program, JAX or the JAX
package, and nothing takes an index, a table or a state the program made.
Each module states the semantics it implements.
"""
