"""Multi-device execution of the port: the (data, model) mesh (mesh.py)."""
