"""nn.Modules of the port: ``modules`` (MLPs, GLO embeddings, template,
hyper sheet), ``warping`` (the translation field), ``nerf`` (NerfModel)."""
