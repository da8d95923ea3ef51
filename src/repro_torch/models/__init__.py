"""The paper's MLPs (MLP-GSC, MLP-HR, LeNet-300-100) for serving."""
