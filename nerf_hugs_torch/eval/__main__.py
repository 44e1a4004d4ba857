from nerf_hugs_torch.eval.driver import main

if __name__ == "__main__":
    main()
