"""The plain reference that decides a run's ``correct``: a forward pass of
the DeepSeek MoE models in plain PyTorch (``model``) and a plain vet of
window records (``vet``).  It imports nothing of the program under test."""
