"""The plain reference: float32 PyTorch written from the published model
descriptions. It imports torch alone: nothing of the program."""
