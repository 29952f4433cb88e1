from polyaxon_tpu_torch.cli.main import cli

if __name__ == "__main__":
    cli()
