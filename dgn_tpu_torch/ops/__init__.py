"""Graph operators: block layout, aggregators, scalers and the CUDA kernels."""
