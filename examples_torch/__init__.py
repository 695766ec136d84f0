"""Example scripts of psa_tpu_torch, each runnable on its own
(``python examples_torch/<name>.py [--device cpu]``) and importable: each
module's ``main(device=..., out_dir=...)`` runs the example and returns its
key arrays."""
