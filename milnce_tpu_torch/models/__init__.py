from milnce_tpu_torch.models.s3dg import S3D  # noqa: F401
