"""Plain PyTorch references the output check holds the program to.  They
import torch alone: nothing of the program, nothing of JAX."""
