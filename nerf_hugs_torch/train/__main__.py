from nerf_hugs_torch.train.driver import main

if __name__ == "__main__":
    main()
