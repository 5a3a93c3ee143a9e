"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
twins: ``changepoint`` (the paper's SSE scan, batched, argmin fused),
``windowvet`` (the whole vet pipeline per ragged window, one launch) and
``ssd`` (the Mamba2 chunked scan, one block per batch row and head).

``runtime`` holds the device policy and builds/loads the kernel library.
A wrapper given CPU tensors runs the plain version (the port's analogue of
Pallas interpret mode); given CUDA tensors it launches its kernel or
raises."""
