from plotpointe_tpu_torch.cli import main

main()
