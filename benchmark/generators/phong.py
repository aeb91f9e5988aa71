"""The Phong sim (the frozen ``generate_phong``), one scene a seed."""

from benchmark import simcopy


def make(scene: dict, seed: int):
    return simcopy.generate_phong(**dict(scene, seed=seed))
