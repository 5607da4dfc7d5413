"""cornellbox: the procedural scene that pbrlab's demo class
`data/cornellbox_suzanne_lucy.obj` stands for (a frozen copy of the
geometry and materials of pbrlab_tpu_torch's `scene/demo.py`, which
copies the reference's .mtl): five diffuse walls, a ceiling area light, a
glossy GGX body ("Monkey") and a random-walk SSS body ("Lucy"), both
icospheres, noise-displaced with `irregular`. Triangles and principled
materials only, so the default hooks (`pbh.scenes`) hand it to the
program and to the plain reference."""
from pbh.meshes import RawScene, icosphere, quad


def make_scene(config):
    """The cornellbox of the configuration: `subdiv` of both bodies,
    `irregular` for the displaced bodies; the light's emission and the
    materials are the demo's."""
    subdiv = int(config["subdiv"])
    irregular = bool(config.get("irregular", False))
    materials = [
        ("Wall_White", dict(base_color=(0.8, 0.8, 0.8), specular=0.0,
                            roughness=0.5)),
        ("Wall_Red", dict(base_color=(0.4096, 0.050353, 0.037544),
                          specular=0.0)),
        ("Wall_Green", dict(base_color=(0.023333, 0.4096, 0.047991),
                            specular=0.0)),
        ("Light", dict(base_color=(0.0, 0.0, 0.0), specular=0.0)),
        ("Monkey", dict(base_color=(0.8, 0.5, 0.2), specular=1.0,
                        roughness=0.01)),
        ("Lucy", dict(base_color=(1.0, 0.8, 0.8), subsurface=1.0,
                      subsurface_radius=(1.0, 0.2, 0.1),
                      subsurface_color=(1.0, 0.8, 0.8), specular=0.0,
                      roughness=0.2)),
    ]
    white, red, green, light, monkey, lucy = range(6)
    s = 0.4
    meshes = [
        quad("floor", [-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1], white),
        quad("ceiling", [-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1],
             white),
        quad("back", [-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1], white),
        quad("left", [-1, 0, -1], [-1, 2, -1], [-1, 2, 1], [-1, 0, 1], red),
        quad("right", [1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1], green),
        quad("light", [-s, 1.98, -s], [s, 1.98, -s], [s, 1.98, s],
             [-s, 1.98, s], light, emission=(3.0, 3.0, 3.0)),
        icosphere("monkey", subdiv, 0.45, (-0.45, 0.75, -0.2), monkey,
                  displace=0.2 if irregular else 0.0),
        icosphere("lucy", subdiv, 0.35,
                  (0.45, 0.95 if irregular else 0.7, 0.25), lucy,
                  scale=(1.0, 2.0, 1.0), displace=0.3 if irregular else 0.0),
    ]
    return RawScene(meshes, materials)
