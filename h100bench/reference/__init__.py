"""The plain reference: PyTorch and NumPy only.

It imports nothing of the program under test and takes nothing the
program made but the outputs it judges.
"""
