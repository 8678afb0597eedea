"""Plain NumPy dual simulation: the yardstick every answer is judged by.

Imports only NumPy and the standard library: nothing of the program under
test, and no JAX.
"""
