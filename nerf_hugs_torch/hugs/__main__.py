from nerf_hugs_torch.hugs import main

if __name__ == "__main__":
    main()
