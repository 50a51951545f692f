"""The plain reference that decides ``correct``: float32 PyTorch written from
the published models, independent of the system under test (it imports
nothing of it and reads nothing it made)."""
