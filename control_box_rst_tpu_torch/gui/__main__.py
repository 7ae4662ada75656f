from control_box_rst_tpu_torch.gui.app import main

if __name__ == "__main__":
    import sys

    sys.exit(main())
